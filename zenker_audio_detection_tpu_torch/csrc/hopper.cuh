// Hopper's warpgroup products (wgmma) and the shared-memory layout they
// read, for the bf16 bodies of attention_pipelined.cu, attention_ws.cu and
// attention_bwd.cu; the mbarriers and TMA loads that feed them, and the
// tensor map of a packed (B, S, H) bf16 tensor. Each source is its own
// library, so everything here is internal to the file that includes it.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N of the warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of wgmma's registers (an
// accumulator, or the A operands of a product in flight) across a fence or
// a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
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
// index within the swizzle period. Tiles start 1024-byte aligned. TMA's
// 128-byte (D = 64) and 64-byte (D = 32) swizzles write the same layout.
template <int D>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  constexpr uint32_t kMask = D == 64 ? 0x70 : 0x30;
  return off ^ ((off >> 3) & kMask);
}

#define WG_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D32(i) WG_D8(i), WG_D8(i + 8), WG_D8(i + 16), WG_D8(i + 24)

// d (64 x N f32, accumulator layout) = a (64 x 16 bf16, registers) * B
// (16 x N bf16 at desc) + (scale_d ? d : 0). Per warp w of the warpgroup,
// rows 16w..16w+15; a and d are laid out as the mma.m16n8k16 fragments
// (flash_common.cuh), d[4n..4n+3] the C fragment of columns 8n..8n+7. kTrans
// reads B MN-major (N contiguous).
template <int kTrans>
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, %69;\n}\n"
      : WG_D32(0), WG_D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(kTrans),
        "r"(scale_d));
}

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
#undef WG_D32
#undef WG_D8

template <int N, int kTrans>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4],
                                      uint64_t desc, int scale_d) {
  if constexpr (N == 128)
    wgmma_n128<kTrans>(d, a, desc, scale_d);
  else if constexpr (N == 64)
    wgmma_n64<kTrans>(d, a, desc, scale_d);
  else
    wgmma_n32<kTrans>(d, a, desc, scale_d);
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
// box (D lanes, rows, 1 batch element) of a tensor_map at (lane c0, row
// c1, element c2)
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

// ------------------------------------------------------- tensor map (host)
using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                            void*, const cuuint64_t*, const cuuint64_t*,
                            const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline Encode encoder() {
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

// (B, S, H) bf16 at ptr as a 3-D map, boxes of (D lanes, rows, 1) in the
// swizzle smem_desc reads; rows past S of a batch element are zero-filled
// (they are not the next element's). False where the encoder refuses it:
// a base address or a row pitch that is not 16-byte aligned, a pitch of
// 2^40 bytes or more.
inline bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S,
                       int H, int D, int rows) {
  Encode encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)H * 2, (cuuint64_t)S * H * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
