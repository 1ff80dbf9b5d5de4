// Elementwise epilogues of the AST trunk's dense layers: the bf16 and f32
// qkv_bias, bias_gelu, residual_layer_norm and layer_norm of the port's
// ops/epilogue.py.
//
// Replaces no Pallas kernel. The JAX package leaves a block's bias adds,
// residual adds, LayerNorms and GELU to XLA, which fuses them with their
// neighbours. In PyTorch each is a pass of its own over a GEMM's output,
// and LayerNorm and GELU three each (a cast to f32, the f32 operation, the
// cast back): at the AST's shapes those passes took more device time than
// the GEMMs. Each kernel here reads a GEMM's output once and writes its
// result once, rounding where the composition of models/ast.py (`_dense`,
// `_layer_norm`, `_block`) rounds and in its order:
//   qkv_bias            q, k and v plus their biases, in place:
//                       bf16(P + b); blockIdx.y picks the tensor;
//   bias_gelu           fc1's product, in place: bf16(gelu(bf16(P + b))),
//                       GELU in f32 by PyTorch's exact-erf formula
//                       0.5 x (1 + erf(x / sqrt(2)));
//   residual_layer_norm t = bf16(P + b), x' = bf16(x + t),
//                       h = bf16(LN_f32(x')); writes x' and h;
//   layer_norm          h = bf16(LN_f32(x)), the first block's ln1.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors in flight a thread (bias passes)
constexpr int kPassBlocks = 4;  // bias passes' CTAs an SM: 64 registers
constexpr int kRowWarps = kThreads / 32;  // LayerNorm rows a block
constexpr int kMaxRow = 1024;  // LayerNorm's widest row, in elements

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
