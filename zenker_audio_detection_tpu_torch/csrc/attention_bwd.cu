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
//   bwd_dq    grid (cdiv(S, 64) query tiles, NH, B), 4 warps of 16 query
//             rows. A warp keeps its Q and g rows as mma A fragments in
//             registers, writes delta for its rows to a (B, NH, S) f32
//             scratch, then walks the 64-key tiles of K and V, staged
//             row-major (rows padded by 8) and double-buffered with
//             cp.async so that tile j + 1 loads while tile j computes. The C
//             fragments of ds_b are the A fragments of dq += ds_b k, and K
//             is read as that product's B operand with ldmatrix.trans from
//             the same staged tile.
//   bwd_dkdv  grid (cdiv(S, 64) key tiles, NH, B), 4 warps of 16 keys. A
//             warp keeps its K and V rows as A fragments and dK, dV in f32
//             registers, and walks the 64-query tiles of Q and g (with their
//             lse and delta), double-buffered the same way, 16 queries at a
//             time: s^T = k q^T, p^T, dv += bf16(p^T) g, dp^T = v g^T,
//             ds^T, dk += bf16(ds^T * scale) q. g and q are the B operands
//             of the last two products, read column-wise with
//             ldmatrix.trans from the row-major tiles.
// ds is computed in both kernels, independently: the two may differ in the
// last bit (exp2f and the product order are the same, the compiler's
// contraction need not be), which is far inside the tolerance. Neither
// kernel uses atomics, so a backward gives the same bits on every run.
//
// Ragged tails (1214 = 18 * 64 + 62): K, V, Q and g rows past S are staged
// as zeros (cp.async with a source size of 0 reads nothing); keys past S get
// p = 0 in bwd_dq and their dk, dv rows are not stored by bwd_dkdv; query
// rows past S are read as zero q, g and o and their lse as +inf, so p = 0
// and they add nothing, whatever the buffers hold past S.
//
// What bounds it on an H100 SXM. At the training shape (B, S, NH, D) =
// (16, 1214, 12, 64) bf16 the function's five products (s, dv, dp, dq, dk)
// are 10 B NH S^2 D = 181 GFLOP, 0.183 ms at 989 TFLOP/s; its bytes (q, k,
// v, o, g in, dq, dk, dv out) are ~0.24 GB, 0.07 ms at 3.35 TB/s. So it is
// bound by operations. This design computes s and dp in both kernels (7
// products of 36.2 GFLOP, 253 GFLOP) to keep every (S, S) tile on chip and
// to need no atomics; mma.sync with cp.async staging reaches a fraction of
// the wgmma/TMA rate, which is later work.
//
// The f32 instances use plain f32 FMAs, never TF32, two threads per row
// (query in bwd_dq, key in bwd_dkdv), each holding D / 2 lanes, with
// synchronous staging, in the manner of the f32 forward body. They need
// only be right.

#include "flash_common.cuh"

namespace {

constexpr int kT = 64;  // rows of a staged tile and of a block (4 warps x 16)
constexpr int kThreads = 128;

// the f32 dot product of two pairs of bf16 values
__device__ __forceinline__ float dot2(uint32_t a, uint32_t b) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
  const float2 y = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&b));
  return x.x * y.x + x.y * y.y;
}

// Stages rows r0..r0+63 of one head (its D lanes at x + base, rows ld
// apart) into a (64, D + 8) bf16 tile, zeros past S.
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* __restrict__ x,
                                      size_t base, int S, int ld, int r0) {
  constexpr int kChunks = kT * D / 8;  // 16-byte chunks
  static_assert(kChunks % kThreads == 0, "staging must divide evenly");
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {
    const int c = threadIdx.x + kThreads * i;
    const int r = c / (D / 8), d8 = (c % (D / 8)) * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * (D + 8) + d8,
               x + base + (size_t)(ok ? r0 + r : 0) * ld + d8, ok);
  }
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

// Stores a warp's 16 x D f32 accumulator rows as bf16, rows < S only.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           const float (&acc)[D / 8][4],
                                           size_t base, int ld, int S, int r0,
                                           int r1, int t) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)r0 * ld + c) =
          pack_bf16(acc[n][0], acc[n][1]);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)r1 * ld + c) =
          pack_bf16(acc[n][2], acc[n][3]);
  }
}

template <int D>
struct PairTiles {  // two row-major (64, D + 8) bf16 tiles, double-buffered
  static constexpr int kLd = D + 8;
  __nv_bfloat16 a[2][kT * kLd];
  __nv_bfloat16 b[2][kT * kLd];
};

// ---------------------------------------------------------------- bwd_dq bf16
// Registers at D = 64: Q and g fragments 16 + 16, dq 32, s and dp of a
// 32-key half 16 + 16, ds_b 8; the launch bounds hold 128 (16 warps/SM).
template <int D>
__global__ void __launch_bounds__(kThreads, 4)
dq_kernel(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          const __nv_bfloat16* __restrict__ o,
          const float* __restrict__ lse, const __nv_bfloat16* __restrict__ g,
          __nv_bfloat16* __restrict__ dq, float* __restrict__ delta, int S,
          int NH, float scale, float scale_log2) {
  using Sm = PairTiles<D>;
  __shared__ __align__(16) Sm sm;  // a: K, b: V
  const int H = NH * D;
  const size_t base = blockIdx.z * ((size_t)S * H) + (size_t)blockIdx.y * D;
  const size_t lbase = ((size_t)blockIdx.z * NH + blockIdx.y) * S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kT + warp * 16 + gr, r1 = r0 + 8;

  stage<D>(sm.a[0], k, base, S, H, 0);
  stage<D>(sm.b[0], v, base, S, H, 0);
  cp_async_commit();

  uint32_t qf[D / 16][4], gf[D / 16][4];
  load_a<D>(qf, q, base, H, S, r0, r1, t);
  load_a<D>(gf, g, base, H, S, r0, r1, t);
  float dl0 = 0.f, dl1 = 0.f;  // delta of rows r0, r1
  {
    uint32_t of[D / 16][4];
    load_a<D>(of, o, base, H, S, r0, r1, t);
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

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int tiles = (S + kT - 1) / kT;
  for (int j = 0; j < tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < tiles) {  // the next tile loads while this one computes
      stage<D>(sm.a[buf ^ 1], k, base, S, H, (j + 1) * kT);
      stage<D>(sm.b[buf ^ 1], v, base, S, H, (j + 1) * kT);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ks = sm.a[buf];
    const __nv_bfloat16* vs = sm.b[buf];

#pragma unroll
    for (int h = 0; h < 2; ++h) {  // two halves of 32 keys
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
        const int row = (h * 32 + n * 8 + gr) * Sm::kLd + 2 * t;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          mma_bf16(s[n], qf[kk], ld32(ks + row + kk * 16),
                   ld32(ks + row + kk * 16 + 8));
          mma_bf16(dp[n], gf[kk], ld32(vs + row + kk * 16),
                   ld32(vs + row + kk * 16 + 8));
        }
      }
      // ds_b; the C fragments of n-tiles 2kk, 2kk+1 are the A fragment of
      // k-step kk of dq += ds_b k
      uint32_t af[2][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = j * kT + h * 32 + n * 8 + 2 * t + e < S;
          const float p0 = ok ? exp2f(s[n][e] * scale_log2 - ls0) : 0.f;
          const float p1 = ok ? exp2f(s[n][2 + e] * scale_log2 - ls1) : 0.f;
          s[n][e] = p0 * (dp[n][e] - dl0) * scale;
          s[n][2 + e] = p1 * (dp[n][2 + e] - dl1) * scale;
        }
        af[n >> 1][(n & 1) * 2 + 0] = pack_bf16(s[n][0], s[n][1]);
        af[n >> 1][(n & 1) * 2 + 1] = pack_bf16(s[n][2], s[n][3]);
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int key = h * 32 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int n = 0; n < D / 8; n += 2) {
          uint32_t b[4];
          ldsm_x4_t(b, ks + key * Sm::kLd + n * 8 + (lane >> 4) * 8);
          mma_bf16(acc[n], af[kk], b[0], b[1]);
          mma_bf16(acc[n + 1], af[kk], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }
  store_rows<D>(dq, acc, base, H, S, r0, r1, t);
}

// -------------------------------------------------------------- bwd_dkdv bf16
template <int D>
struct DkvTiles {
  PairTiles<D> x;  // a: Q, b: g
  float lse[2][kT];
  float delta[2][kT];
};

// Registers at D = 64: dK and dV 32 + 32, K and V fragments 16 + 16, s^T
// and dp^T of 16 queries 8 + 8, p^T and ds^T fragments 4 + 4: about 140
// with addresses, so the launch bounds allow 168 (12 warps/SM) rather than
// spill under 128.
template <int D>
__global__ void __launch_bounds__(kThreads, 3)
dkdv_kernel(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            const __nv_bfloat16* __restrict__ g,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int S, int NH, float scale, float scale_log2) {
  using Sm = PairTiles<D>;
  __shared__ __align__(16) DkvTiles<D> sm;
  const int H = NH * D;
  const size_t base = blockIdx.z * ((size_t)S * H) + (size_t)blockIdx.y * D;
  const size_t lbase = ((size_t)blockIdx.z * NH + blockIdx.y) * S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kT + warp * 16 + gr, r1 = r0 + 8;  // keys

  auto stage_all = [&](int buf, int q0) {
    stage<D>(sm.x.a[buf], q, base, S, H, q0);
    stage<D>(sm.x.b[buf], g, base, S, H, q0);
    const int i = threadIdx.x & (kT - 1);
    const bool ok = q0 + i < S;
    const size_t at = lbase + (ok ? q0 + i : 0);
    if (threadIdx.x < kT)
      cp_async4(&sm.lse[buf][i], lse + at, ok);
    else
      cp_async4(&sm.delta[buf][i], delta + at, ok);
  };
  stage_all(0, 0);
  cp_async_commit();

  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a<D>(kf, k, base, H, S, r0, r1, t);
  load_a<D>(vf, v, base, H, S, r0, r1, t);
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  const int tiles = (S + kT - 1) / kT;
  for (int j = 0; j < tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < tiles) stage_all(buf ^ 1, (j + 1) * kT);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* qs = sm.x.a[buf];
    const __nv_bfloat16* gs = sm.x.b[buf];

#pragma unroll
    for (int h = 0; h < kT / 16; ++h) {  // 16 queries at a time
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
        dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
        const int row = (h * 16 + n * 8 + gr) * Sm::kLd + 2 * t;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          mma_bf16(st[n], kf[kk], ld32(qs + row + kk * 16),
                   ld32(qs + row + kk * 16 + 8));
          mma_bf16(dpt[n], vf[kk], ld32(gs + row + kk * 16),
                   ld32(gs + row + kk * 16 + 8));
        }
      }
      // columns are queries: n-tile n holds queries h*16 + n*8 + 2t + e
      uint32_t pf[4], dsf[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = h * 16 + n * 8 + 2 * t + e;
          const bool ok = j * kT + i < S;
          const float l = ok ? sm.lse[buf][i] : INFINITY;
          const float dl = ok ? sm.delta[buf][i] : 0.f;
          const float p0 = exp2f(st[n][e] * scale_log2 - l);
          const float p1 = exp2f(st[n][2 + e] * scale_log2 - l);
          st[n][e] = p0;
          st[n][2 + e] = p1;
          dpt[n][e] = p0 * (dpt[n][e] - dl) * scale;
          dpt[n][2 + e] = p1 * (dpt[n][2 + e] - dl) * scale;
        }
        pf[n * 2 + 0] = pack_bf16(st[n][0], st[n][1]);
        pf[n * 2 + 1] = pack_bf16(st[n][2], st[n][3]);
        dsf[n * 2 + 0] = pack_bf16(dpt[n][0], dpt[n][1]);
        dsf[n * 2 + 1] = pack_bf16(dpt[n][2], dpt[n][3]);
      }
      const int row = h * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        const int at = row * Sm::kLd + n * 8 + (lane >> 4) * 8;
        uint32_t b[4];
        ldsm_x4_t(b, gs + at);
        mma_bf16(dva[n], pf, b[0], b[1]);
        mma_bf16(dva[n + 1], pf, b[2], b[3]);
        ldsm_x4_t(b, qs + at);
        mma_bf16(dka[n], dsf, b[0], b[1]);
        mma_bf16(dka[n + 1], dsf, b[2], b[3]);
      }
    }
    __syncthreads();
  }
  store_rows<D>(dk, dka, base, H, S, r0, r1, t);
  store_rows<D>(dv, dva, base, H, S, r0, r1, t);
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

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* lse, const void* g, void* dq, void* delta, int S,
              int NH, int D, dim3 grid, int threads, int smem,
              cudaStream_t st) {
  if (threads != kThreads || smem != 0) return (int)cudaErrorInvalidValue;
  const float sc = scale_of(D), sl = scale_log2_of(D);
#define DQ_ARGS                                                          \
  (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const float*)lse, \
      (const T*)g, (T*)dq, (float*)delta, S, NH, sc, sl
  if constexpr (sizeof(T) == 2) {
    if (D == 32) dq_kernel<32><<<grid, threads, 0, st>>>(DQ_ARGS);
    else if (D == 64) dq_kernel<64><<<grid, threads, 0, st>>>(DQ_ARGS);
    else return (int)cudaErrorInvalidValue;
  } else {
    if (D == 32) dq_kernel_f32<32><<<grid, threads, 0, st>>>(DQ_ARGS);
    else if (D == 64) dq_kernel_f32<64><<<grid, threads, 0, st>>>(DQ_ARGS);
    else return (int)cudaErrorInvalidValue;
  }
#undef DQ_ARGS
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v, const void* g,
                const void* lse, const void* delta, void* dk, void* dv,
                int S, int NH, int D, dim3 grid, int threads, int smem,
                cudaStream_t st) {
  if (threads != kThreads || smem != 0) return (int)cudaErrorInvalidValue;
  const float sc = scale_of(D), sl = scale_log2_of(D);
#define DKDV_ARGS                                                        \
  (const T*)q, (const T*)k, (const T*)v, (const T*)g, (const float*)lse, \
      (const float*)delta, (T*)dk, (T*)dv, S, NH, sc, sl
  if constexpr (sizeof(T) == 2) {
    if (D == 32) dkdv_kernel<32><<<grid, threads, 0, st>>>(DKDV_ARGS);
    else if (D == 64) dkdv_kernel<64><<<grid, threads, 0, st>>>(DKDV_ARGS);
    else return (int)cudaErrorInvalidValue;
  } else {
    if (D == 32) dkdv_kernel_f32<32><<<grid, threads, 0, st>>>(DKDV_ARGS);
    else if (D == 64)
      dkdv_kernel_f32<64><<<grid, threads, 0, st>>>(DKDV_ARGS);
    else return (int)cudaErrorInvalidValue;
  }
#undef DKDV_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points. Pointers are device pointers: q, k, v, o, g, dq, dk, dv
// contiguous (B, S, NH * D) tensors of the entry's dtype, 16-byte aligned;
// lse and delta contiguous (B, NH, S) f32. (gx, gy, gz), threads and the
// dynamic shared memory in bytes (0) are ops/attention.py's
// launch_geometry; `stream` is a cudaStream_t. Returns the cudaError_t of
// the launch (0 on success); an instance that does not exist is
// cudaErrorInvalidValue. The caller validates shapes. bwd_dq writes delta,
// which bwd_dkdv reads: launch them in that order on one stream.
#define DQ_ENTRY(name, T)                                                    \
  extern "C" int name(const void* q, const void* k, const void* v,          \
                      const void* o, const void* lse, const void* g,        \
                      void* dq, void* delta, int S, int NH, int D, int gx,  \
                      int gy, int gz, int threads, int smem, void* stream) { \
    return launch_dq<T>(q, k, v, o, lse, g, dq, delta, S, NH, D,            \
                        dim3(gx, gy, gz), threads, smem,                    \
                        (cudaStream_t)stream);                               \
  }
#define DKDV_ENTRY(name, T)                                                  \
  extern "C" int name(const void* q, const void* k, const void* v,          \
                      const void* g, const void* lse, const void* delta,    \
                      void* dk, void* dv, int S, int NH, int D, int gx,     \
                      int gy, int gz, int threads, int smem, void* stream) { \
    return launch_dkdv<T>(q, k, v, g, lse, delta, dk, dv, S, NH, D,         \
                          dim3(gx, gy, gz), threads, smem,                  \
                          (cudaStream_t)stream);                             \
  }

DQ_ENTRY(mha_packed_bwd_dq_bf16, __nv_bfloat16)
DQ_ENTRY(mha_packed_bwd_dq_f32, float)
DKDV_ENTRY(mha_packed_bwd_dkdv_bf16, __nv_bfloat16)
DKDV_ENTRY(mha_packed_bwd_dkdv_f32, float)
