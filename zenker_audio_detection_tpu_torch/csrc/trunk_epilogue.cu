// Elementwise epilogues of the AST and BEATs trunks' dense layers: the bf16
// and f32 qkv_bias, bias_gelu, residual_layer_norm, layer_norm,
// post_residual_layer_norm and relpos_gates of the port's ops/epilogue.py.
//
// Replaces no Pallas kernel. The JAX package leaves a block's bias adds,
// residual adds, LayerNorms and GELU to XLA, which fuses them with their
// neighbours. In PyTorch each is a pass of its own over a GEMM's output,
// and LayerNorm and GELU three each (a cast to f32, the f32 operation, the
// cast back): at the AST's shapes those passes took more device time than
// the GEMMs. Each kernel here reads a GEMM's output once and writes its
// result once, rounding where the composition of models/ast.py (`_dense`,
// `_layer_norm`, `_block`) or models/beats.py (`_block`, `relpos_gates`)
// rounds and in its order:
//   qkv_bias            q, k and v plus their biases, in place:
//                       bf16(P + b); blockIdx.y picks the tensor;
//   bias_gelu           fc1's product, in place: bf16(gelu(bf16(P + b))),
//                       GELU in f32 by PyTorch's exact-erf formula
//                       0.5 x (1 + erf(x / sqrt(2)));
//   residual_layer_norm t = bf16(P + b), x' = bf16(x + t),
//                       h = bf16(LN_f32(x')); writes x' and h;
//   layer_norm          h = bf16(LN_f32(x)), the first block's ln1;
//   post_residual_layer_norm
//                       BEATs's post-LN step on a product P that holds its
//                       bias: s = bf16(P + alpha x) as torch.add(P, x,
//                       alpha=alpha) computes it (f32 opmath, the product
//                       and the sum one fma), h = bf16(LN_f32(s)); writes
//                       h only;
//   relpos_gates        BEATs's gates from q (rows of heads of 64): z = q_h
//                       W + b in f32 (W 64 x 8), (a, b) = sigmoid of the
//                       sums of z's two groups of four, g = a (b grep_a_h -
//                       1) + 2, each step rounded to f32 as ATen's separate
//                       passes round it, written (batch, head, token).
// LayerNorm keeps f32 statistics: the mean, then the variance about it,
// rstd = rsqrt(var + eps), h = gamma (rstd (x - mean)) + beta. In f32 every
// rounding is an identity.
//
// What bounds them on an H100 SXM: bytes. Each does a few operations an
// element against 4 to 8 bytes moved, far below the 295 operations a byte
// at which the tensor cores would bind. At 128 x 1214 rows of 768 (3072
// for fc1) in bf16: qkv_bias moves 1.43 GB (0.427 ms at 3.35 TB/s),
// residual_layer_norm 0.955 GB (0.285 ms), bias_gelu 1.91 GB (0.570 ms).
// So the design moves each byte once, in 16-byte vectors:
//   * qkv_bias and bias_gelu: each thread loads kUnroll vectors, strided
//     by the block so that a warp's loads are contiguous, before it
//     computes any, to keep enough loads in flight; a vector's bias is at
//     its index modulo the row's vectors, taken by a 32-bit multiply-high
//     (Divider: a 64-bit `%` cost bias_gelu 0.89 against 0.66 ms on an
//     H100 at 128 x 1214 rows, with the erf, per element, the other cost);
//   * the LayerNorms: one warp a row, the row in registers (lane l holds
//     the row's vectors l, l + 32, ...), loaded whole (x and the product)
//     before any arithmetic, mean and variance each reduced by shuffles
//     over the registers, no shared memory; rows up to kMaxRow elements.
//     Both forms share that body (`layer_norm_row`), so post_residual's
//     h is layer_norm's on the sum, bit for bit;
//   * the gates: one warp a row, the row's vectors laid over the lanes as
//     the LayerNorms lay them, so that a head is 64 / kVec neighbouring
//     lanes and a lane meets the same kVec rows of W in every head: they
//     stay in its registers for every row the warp walks (kGateBlocks CTAs
//     an SM stride over the rows, the next row's loads in flight during
//     this one's arithmetic). Each lane's 8 partial outputs are
//     reduce-scattered over its head's lanes by shuffles, so that a lane
//     ends with one output. At 128 x 512 rows of 768 bf16 it reads 100.7
//     MB and writes 3.1 MB (0.031 ms at 3.35 TB/s) for 0.8 GFLOP.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors in flight a thread (bias passes)
constexpr int kPassBlocks = 4;  // bias passes' CTAs an SM: 64 registers
constexpr int kRowWarps = kThreads / 32;  // LayerNorm rows a block
constexpr int kMaxRow = 1024;  // LayerNorm's widest row, in elements
constexpr int kGateHead = 64;  // the gates' head width
constexpr int kGateOut = 8;  // grep_linear's outputs: two groups of four
constexpr int kGateBlocks = 2;  // the gates' CTAs an SM: 128 registers

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};

// x rounded to T, as the composition's tensor of dtype T holds it
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return Elem<T>::load(Elem<T>::store(x));
}

template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);  // elements of a 16-byte vector

template <typename T>
struct alignas(16) Vec {
  T e[kVec<T>];
};

// n / d for n < 2^31 by a multiply-high and a shift (Granlund and
// Montgomery's round-up method, as PyTorch's IntDivider)
struct Divider {
  unsigned magic, shift, d;
};

Divider make_divider(unsigned d) {
  unsigned shift = 0;
  while ((1u << shift) < d) ++shift;
  const uint64_t one = 1;
  const uint64_t magic = ((one << 32) * ((one << shift) - d)) / d + 1;
  return Divider{(unsigned)magic, shift, d};
}

__device__ __forceinline__ unsigned modulo(unsigned n, Divider v) {
  return n - ((__umulhi(n, v.magic) + n) >> v.shift) * v.d;
}

// PyTorch's GeluCUDAKernelImpl (approximate="none") on an f32 tensor
__device__ __forceinline__ float gelu(float x) {
  constexpr float kAlpha = 0.70710678118654752440f;  // M_SQRT1_2
  return x * 0.5f * (1.0f + erff(x * kAlpha));
}

// p[i] = bf16(p[i] + b[i % width]) over n < 2^31 vectors (width vectors a
// row), then GELU where kGelu
template <typename T, bool kGelu>
__device__ __forceinline__ void bias_pass(T* __restrict__ p,
                                          const T* __restrict__ b, unsigned n,
                                          Divider width) {
  Vec<T>* pv = reinterpret_cast<Vec<T>*>(p);
  const Vec<T>* bv = reinterpret_cast<const Vec<T>*>(b);
  const unsigned first = blockIdx.x * kThreads * kUnroll + threadIdx.x;
  Vec<T> x[kUnroll], y[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned i = first + u * kThreads;
    if (i < n) {
      x[u] = pv[i];
      y[u] = bv[modulo(i, width)];
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned i = first + u * kThreads;
    if (i < n) {
      Vec<T> out;
#pragma unroll
      for (int e = 0; e < kVec<T>; ++e) {
        float t = rounded<T>(Elem<T>::load(x[u].e[e]) +
                             Elem<T>::load(y[u].e[e]));
        if constexpr (kGelu) t = gelu(t);
        out.e[e] = Elem<T>::store(t);
      }
      pv[i] = out;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kPassBlocks)
    qkv_bias_elementwise_kernel(T* q, T* k, T* v, const T* bq, const T* bk,
                                const T* bv, unsigned n, Divider width) {
  const int which = blockIdx.y;
  bias_pass<T, false>(which == 0 ? q : which == 1 ? k : v,
                      which == 0 ? bq : which == 1 ? bk : bv, n, width);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kPassBlocks)
    bias_gelu_elementwise_kernel(T* p, const T* b, unsigned n,
                                 Divider width) {
  bias_pass<T, true>(p, b, n, width);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// h = bf16(LN_f32(row)) of the row a warp holds, written to h_out's
// vectors base + lane + 32 c: r[c] is the row's vector lane + 32 c (of
// nvec), `sum` the sum of the lane's elements
template <typename T, int kLaneVecs>
__device__ __forceinline__ void layer_norm_row(
    const float (&r)[kLaneVecs][kVec<T>], float sum, int lane, int nvec,
    int width, float eps, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ h_out, int64_t base) {
  constexpr int kV = kVec<T>;
  const float mean = warp_sum(sum) / (float)width;
  float sq = 0.0f;
#pragma unroll
  for (int c = 0; c < kLaneVecs; ++c) {
    if (lane + c * 32 < nvec) {
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const float d = r[c][e] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)width + eps);
#pragma unroll
  for (int c = 0; c < kLaneVecs; ++c) {
    const int j = lane + c * 32;
    if (j < nvec) {
      float g[kV], be[kV];
#pragma unroll
      for (int q = 0; q < kV / 4; ++q) {
        const int f4 = j * kV / 4 + q;
        const float4 g4 = reinterpret_cast<const float4*>(gamma)[f4];
        const float4 b4 = reinterpret_cast<const float4*>(beta)[f4];
        g[4 * q] = g4.x;
        g[4 * q + 1] = g4.y;
        g[4 * q + 2] = g4.z;
        g[4 * q + 3] = g4.w;
        be[4 * q] = b4.x;
        be[4 * q + 1] = b4.y;
        be[4 * q + 2] = b4.z;
        be[4 * q + 3] = b4.w;
      }
      Vec<T> hv;
#pragma unroll
      for (int e = 0; e < kV; ++e)
        hv.e[e] = Elem<T>::store(g[e] * (rstd * (r[c][e] - mean)) + be[e]);
      reinterpret_cast<Vec<T>*>(h_out)[base + j] = hv;
    }
  }
}

// One warp a row of `width` elements: x' = bf16(x + bf16(p + b)) where
// kResidual (written to x_out), h = bf16(LN_f32(x')) (to h_out)
template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads)
    residual_ln_elementwise_kernel(const T* __restrict__ p,
                                   const T* __restrict__ b,
                                   const T* __restrict__ x,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta,
                                   T* __restrict__ x_out,
                                   T* __restrict__ h_out, int rows, int width,
                                   float eps) {
  constexpr int kV = kVec<T>;
  constexpr int kLaneVecs = kMaxRow / (kV * 32);
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp: one row
  const int nvec = width / kV;
  const int64_t base = (int64_t)row * nvec;
  Vec<T> xv[kLaneVecs], pv[kLaneVecs];
#pragma unroll
  for (int c = 0; c < kLaneVecs; ++c) {
    const int j = lane + c * 32;
    if (j < nvec) {
      xv[c] = reinterpret_cast<const Vec<T>*>(x)[base + j];
      if constexpr (kResidual)
        pv[c] = reinterpret_cast<const Vec<T>*>(p)[base + j];
    }
  }
  float r[kLaneVecs][kV];
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < kLaneVecs; ++c) {
    const int j = lane + c * 32;
    if (j < nvec) {
      if constexpr (kResidual) {
        const Vec<T> bv = reinterpret_cast<const Vec<T>*>(b)[j];
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          const float t = rounded<T>(Elem<T>::load(pv[c].e[e]) +
                                     Elem<T>::load(bv.e[e]));
          xv[c].e[e] = Elem<T>::store(Elem<T>::load(xv[c].e[e]) + t);
        }
        reinterpret_cast<Vec<T>*>(x_out)[base + j] = xv[c];
      }
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        r[c][e] = Elem<T>::load(xv[c].e[e]);
        sum += r[c][e];
      }
    }
  }
  layer_norm_row<T, kLaneVecs>(r, sum, lane, nvec, width, eps, gamma, beta,
                               h_out, base);
}

// One warp a row of `width` elements: s = bf16(p + alpha x), the sum of
// torch.add(p, x, alpha=alpha) (ATen's opmath f32, its `self + alpha *
// other` contracted to one fma), then h = bf16(LN_f32(s)) to h_out; s is
// not written
template <typename T>
__global__ void __launch_bounds__(kThreads)
    post_residual_ln_elementwise_kernel(const T* __restrict__ p,
                                        const T* __restrict__ x,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta,
                                        T* __restrict__ h_out, int rows,
                                        int width, float alpha, float eps) {
  constexpr int kV = kVec<T>;
  constexpr int kLaneVecs = kMaxRow / (kV * 32);
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp: one row
  const int nvec = width / kV;
  const int64_t base = (int64_t)row * nvec;
  Vec<T> xv[kLaneVecs], pv[kLaneVecs];
#pragma unroll
  for (int c = 0; c < kLaneVecs; ++c) {
    const int j = lane + c * 32;
    if (j < nvec) {
      xv[c] = reinterpret_cast<const Vec<T>*>(x)[base + j];
      pv[c] = reinterpret_cast<const Vec<T>*>(p)[base + j];
    }
  }
  float r[kLaneVecs][kV];
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < kLaneVecs; ++c) {
    if (lane + c * 32 < nvec) {
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        r[c][e] = rounded<T>(__fmaf_rn(alpha, Elem<T>::load(xv[c].e[e]),
                                       Elem<T>::load(pv[c].e[e])));
        sum += r[c][e];
      }
    }
  }
  layer_norm_row<T, kLaneVecs>(r, sum, lane, nvec, width, eps, gamma, beta,
                               h_out, base);
}

// One step of a reduce-scatter over lanes kM apart: a lane keeps the half
// (kN outputs) of z[0 : 2 kN] that its lane bit kM picks, adds its
// partner's partial sums of that half, and holds them in z[0 : kN]
template <int kM, int kN>
__device__ __forceinline__ void scatter_half(float (&z)[kGateOut], int lane) {
  const bool upper = lane & kM;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const float send = upper ? z[i] : z[i + kN];
    const float keep = upper ? z[i + kN] : z[i];
    z[i] = keep + __shfl_xor_sync(0xffffffffu, send, kM);
  }
}

// The gates of rows = batch x seq tokens of `heads` heads of 64 in q (a
// row's vector j holds elements of head j / kG): gates[(n, h, t)] = a (b
// grep_a[h] - 1) + 2 of token t of item n, where (a, b) = sigmoid of the
// sums of z[0:4] and z[4:8], z = q_h w + wb (w (64, 8), all f32). Each
// warp walks rows gridDim.x x kRowWarps apart.
template <typename T>
__global__ void __launch_bounds__(kThreads, kGateBlocks)
    relpos_gate_elementwise_kernel(const T* __restrict__ q,
                                   const float* __restrict__ w,
                                   const float* __restrict__ wb,
                                   const float* __restrict__ grep_a,
                                   float* __restrict__ gates, int rows,
                                   int seq, int heads) {
  constexpr int kV = kVec<T>;
  constexpr int kG = kGateHead / kV;  // lanes a head: 8 (bf16), 16 (f32)
  constexpr int kLaneVecs = kMaxRow / (kV * 32);
  const int lane = threadIdx.x % 32;
  const int nvec = heads * kG;
  // the lane's elements of a head are W's rows d0 .. d0 + kV - 1
  const int d0 = (lane % kG) * kV;
  float wl[kV][kGateOut];
#pragma unroll
  for (int e = 0; e < kV; ++e)
#pragma unroll
    for (int o = 0; o < kGateOut; ++o) wl[e][o] = w[(d0 + e) * kGateOut + o];
  // the output a lane holds after the reduce-scatter: its lane bits kG / 2,
  // kG / 4 and kG / 8 pick the half, quarter and eighth of the eight
  const int mine = ((lane & (kG / 2)) ? 4 : 0) + ((lane & (kG / 4)) ? 2 : 0) +
                   ((lane & (kG / 8)) ? 1 : 0);
  const float bias = wb[mine];
  const int stride = gridDim.x * kRowWarps;
  int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  Vec<T> cur[kLaneVecs], next[kLaneVecs];
  auto load = [&](Vec<T>(&v)[kLaneVecs], int at) {
    const int64_t base = (int64_t)at * nvec;
#pragma unroll
    for (int c = 0; c < kLaneVecs; ++c)
      if (lane + c * 32 < nvec)
        v[c] = reinterpret_cast<const Vec<T>*>(q)[base + lane + c * 32];
  };
  if (row < rows) load(cur, row);
  for (; row < rows; row += stride) {  // warp-uniform: every lane shuffles
    if (row + stride < rows) load(next, row + stride);
    const int n = row / seq, t = row - n * seq;
#pragma unroll
    for (int c = 0; c < kLaneVecs; ++c) {
      if (c * 32 >= nvec) break;  // warp-uniform
      const int j = lane + c * 32;
      // lanes past the row's vectors are whole heads: they shuffle zeros
      float z[kGateOut] = {};
      if (j < nvec) {
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          const float qe = Elem<T>::load(cur[c].e[e]);
#pragma unroll
          for (int o = 0; o < kGateOut; ++o) z[o] = fmaf(qe, wl[e][o], z[o]);
        }
      }
      // reduce-scatter over the head's lanes: 8 -> 4 -> 2 -> 1 outputs
      scatter_half<kG / 2, 4>(z, lane);
      scatter_half<kG / 4, 2>(z, lane);
      scatter_half<kG / 8, 1>(z, lane);
      // f32: two lanes still share each output
#pragma unroll
      for (int m = kG / 16; m >= 1; m /= 2)
        z[0] += __shfl_xor_sync(0xffffffffu, z[0], m);
      float s = z[0] + bias;  // z[mine], the bias inside as F.linear's
      s += __shfl_xor_sync(0xffffffffu, s, kG / 8);
      s += __shfl_xor_sync(0xffffffffu, s, kG / 4);
      // PyTorch's sigmoid of an f32 tensor
      const float sig = 1.0f / (1.0f + expf(-s));
      const float other = __shfl_xor_sync(0xffffffffu, sig, kG / 2);
      if (j < nvec && lane % kG == 0) {
        const int h = j / kG;
        // (b grep_a - 1), times a, plus 2: one rounding each, no fma
        const float g = __fadd_rn(
            __fmul_rn(sig, __fsub_rn(__fmul_rn(other, grep_a[h]), 1.0f)),
            2.0f);
        gates[((int64_t)n * heads + h) * seq + t] = g;
      }
    }
#pragma unroll
    for (int c = 0; c < kLaneVecs; ++c) cur[c] = next[c];
  }
}

// the vectors of a bias pass over (rows, width), or -1 where the kernels'
// 32-bit indices do not take them
template <typename T>
int64_t pass_vectors(int rows, int width) {
  if (rows < 0 || width <= 0 || width % kVec<T>) return -1;
  const int64_t n = (int64_t)rows * (width / kVec<T>);
  return n + kThreads * kUnroll < ((int64_t)1 << 31) ? n : -1;
}

template <typename T>
int qkv_bias(void* q, void* k, void* v, const void* bq, const void* bk,
             const void* bv, int rows, int width, void* stream) {
  const int64_t n = pass_vectors<T>(rows, width);
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const dim3 grid((unsigned)((n + kThreads * kUnroll - 1) /
                             (kThreads * kUnroll)),
                  3);
  qkv_bias_elementwise_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (T*)q, (T*)k, (T*)v, (const T*)bq, (const T*)bk, (const T*)bv,
      (unsigned)n, make_divider(width / kVec<T>));
  return (int)cudaGetLastError();
}

template <typename T>
int bias_gelu(void* p, const void* b, int rows, int width, void* stream) {
  const int64_t n = pass_vectors<T>(rows, width);
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const unsigned grid =
      (unsigned)((n + kThreads * kUnroll - 1) / (kThreads * kUnroll));
  bias_gelu_elementwise_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (T*)p, (const T*)b, (unsigned)n, make_divider(width / kVec<T>));
  return (int)cudaGetLastError();
}

template <typename T, bool kResidual>
int residual_ln(const void* p, const void* b, const void* x,
                const void* gamma, const void* beta, void* x_out, void* h_out,
                int rows, int width, float eps, void* stream) {
  if (rows < 0 || width <= 0 || width % kVec<T> || width > kMaxRow)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const unsigned grid = (unsigned)((rows + kRowWarps - 1) / kRowWarps);
  residual_ln_elementwise_kernel<T, kResidual>
      <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)p, (const T*)b, (const T*)x, (const float*)gamma,
          (const float*)beta, (T*)x_out, (T*)h_out, rows, width, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int post_residual_ln(const void* p, const void* x, const void* gamma,
                     const void* beta, void* h_out, int rows, int width,
                     float alpha, float eps, void* stream) {
  if (rows < 0 || width <= 0 || width % kVec<T> || width > kMaxRow)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const unsigned grid = (unsigned)((rows + kRowWarps - 1) / kRowWarps);
  post_residual_ln_elementwise_kernel<T>
      <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)p, (const T*)x, (const float*)gamma, (const float*)beta,
          (T*)h_out, rows, width, alpha, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int relpos_gates(const void* q, const void* w, const void* wb,
                 const void* grep_a, void* gates, int batch, int seq,
                 int width, int heads, void* stream) {
  const int64_t rows = (int64_t)batch * seq;
  if (batch < 0 || seq < 0 || heads <= 0 || width != heads * kGateHead ||
      width > kMaxRow || rows >= ((int64_t)1 << 31))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int64_t needed = (rows + kRowWarps - 1) / kRowWarps;
  const unsigned grid =
      (unsigned)(needed < (int64_t)sms * kGateBlocks ? needed
                                                     : (int64_t)sms * kGateBlocks);
  relpos_gate_elementwise_kernel<T>
      <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)q, (const float*)w, (const float*)wb,
          (const float*)grep_a, (float*)gates, (int)rows, seq, heads);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: contiguous (rows, width); bq, bk, bv: (width)
extern "C" int qkv_bias_bf16(void* q, void* k, void* v, const void* bq,
                             const void* bk, const void* bv, int rows,
                             int width, void* stream) {
  return qkv_bias<__nv_bfloat16>(q, k, v, bq, bk, bv, rows, width, stream);
}

extern "C" int qkv_bias_f32(void* q, void* k, void* v, const void* bq,
                            const void* bk, const void* bv, int rows,
                            int width, void* stream) {
  return qkv_bias<float>(q, k, v, bq, bk, bv, rows, width, stream);
}

// p: contiguous (rows, width); b: (width)
extern "C" int bias_gelu_bf16(void* p, const void* b, int rows, int width,
                              void* stream) {
  return bias_gelu<__nv_bfloat16>(p, b, rows, width, stream);
}

extern "C" int bias_gelu_f32(void* p, const void* b, int rows, int width,
                             void* stream) {
  return bias_gelu<float>(p, b, rows, width, stream);
}

// p, x, x_out, h_out: contiguous (rows, width); b: (width); gamma, beta:
// (width) f32
extern "C" int residual_layer_norm_bf16(const void* p, const void* b,
                                        const void* x, const void* gamma,
                                        const void* beta, void* x_out,
                                        void* h_out, int rows, int width,
                                        float eps, void* stream) {
  return residual_ln<__nv_bfloat16, true>(p, b, x, gamma, beta, x_out, h_out,
                                          rows, width, eps, stream);
}

extern "C" int residual_layer_norm_f32(const void* p, const void* b,
                                       const void* x, const void* gamma,
                                       const void* beta, void* x_out,
                                       void* h_out, int rows, int width,
                                       float eps, void* stream) {
  return residual_ln<float, true>(p, b, x, gamma, beta, x_out, h_out, rows,
                                  width, eps, stream);
}

// x, h_out: contiguous (rows, width); gamma, beta: (width) f32
extern "C" int layer_norm_bf16(const void* x, const void* gamma,
                               const void* beta, void* h_out, int rows,
                               int width, float eps, void* stream) {
  return residual_ln<__nv_bfloat16, false>(nullptr, nullptr, x, gamma, beta,
                                           nullptr, h_out, rows, width, eps,
                                           stream);
}

extern "C" int layer_norm_f32(const void* x, const void* gamma,
                              const void* beta, void* h_out, int rows,
                              int width, float eps, void* stream) {
  return residual_ln<float, false>(nullptr, nullptr, x, gamma, beta, nullptr,
                                   h_out, rows, width, eps, stream);
}

// p, x, h_out: contiguous (rows, width); gamma, beta: (width) f32
extern "C" int post_residual_layer_norm_bf16(const void* p, const void* x,
                                             const void* gamma,
                                             const void* beta, void* h_out,
                                             int rows, int width, float alpha,
                                             float eps, void* stream) {
  return post_residual_ln<__nv_bfloat16>(p, x, gamma, beta, h_out, rows,
                                         width, alpha, eps, stream);
}

extern "C" int post_residual_layer_norm_f32(const void* p, const void* x,
                                            const void* gamma,
                                            const void* beta, void* h_out,
                                            int rows, int width, float alpha,
                                            float eps, void* stream) {
  return post_residual_ln<float>(p, x, gamma, beta, h_out, rows, width,
                                 alpha, eps, stream);
}

// q: contiguous (batch, seq, width = heads x 64); w: (64, 8), wb: (8),
// grep_a: (heads), gates: (batch, heads, seq), all f32
extern "C" int relpos_gates_bf16(const void* q, const void* w, const void* wb,
                                 const void* grep_a, void* gates, int batch,
                                 int seq, int width, int heads,
                                 void* stream) {
  return relpos_gates<__nv_bfloat16>(q, w, wb, grep_a, gates, batch, seq,
                                     width, heads, stream);
}

extern "C" int relpos_gates_f32(const void* q, const void* w, const void* wb,
                                const void* grep_a, void* gates, int batch,
                                int seq, int width, int heads, void* stream) {
  return relpos_gates<float>(q, w, wb, grep_a, gates, batch, seq, width,
                             heads, stream);
}
