// Hopper (sm_90a) primitives in inline PTX: the tensor memory accelerator
// (TMA) with its tensor maps, `mbarrier`s, the shared-memory matrix
// descriptor, `wgmma` (its fence / commit / wait and the m64nNk16 bf16
// products the port uses) and `setmaxnreg`.
//
// Tiles live in shared memory as TMA writes them with the 128-byte
// swizzle: boxes of [rows][64] bf16, a 128-byte line a row, the eight
// 16-byte chunks of line r stored at chunk ^ (r % 8); a box starts on a
// 1,024-byte boundary.  A tile [R][D] is ceil(D / 64) such boxes, box c
// at c * R * 128 bytes (columns past D zero-filled by the TMA).  Its two
// readings by `wgmma`:
//  - K-major (rows the M or N index, columns K): k-step kk (16 columns)
//    starts at box kk / 4, byte (kk % 4) * 32 of the line; 8-row groups
//    1,024 bytes apart (the stride byte offset, SBO);
//  - MN-major (rows K, columns N; the "transposed" B, trans-b = 1):
//    k-step kk starts at row 16 kk (2,048 bytes on), N <= 64 columns of
//    one box; 8-row groups 1,024 bytes apart, the next 64 columns one box
//    on (the leading byte offset, LBO: R * 128).
// The accumulator of m64nN is four warps of the m16n8 C layout stacked:
// warp w, lane (g = lane / 4, t = lane % 4) holds d[4i + e] at row
// 16 w + g + 8 (e / 2), column 8 i + 2 t + (e % 2); the A fragment of an
// RS product takes the mma.sync m16n8k16 A layout, which two n8 column
// groups of an accumulator are.
#pragma once

#include <cuda.h>           // CUtensorMap and its enums (no -lcuda: the
#include <cuda_runtime.h>   // encoder is reached through the runtime)

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// p moved up to the next 1,024-byte boundary of shared memory (a swizzled
// box's alignment; the launch asks for 1,024 bytes more than the layout)
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (the TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// one arrival, and `bytes` more for the phase to wait for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// `bytes` more for the phase to wait for, no arrival
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// a wait this long (~17 s at the H100's clock) is a fault of the kernel,
// not a slow copy: it traps, and the launch fails, rather than hang the
// card
constexpr long long kWaitCycles = 1ll << 35;

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > kWaitCycles) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// box (c0, c1, c2, c3) of `map` into shared memory at dst, its bytes
// counted on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the box at src back to (c0, c1, c2, c3) of `map` (rows outside the
// tensor not written); then tma_store_wait
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_wait() {
  asm volatile(
      "cp.async.bulk.commit_group;\n"
      "cp.async.bulk.wait_group 0;\n" ::
          : "memory");
}

// 4 bytes at src into shared memory at dst, or zeros when !pred (nothing
// read); cp_async_arrive makes `bar` count one arrival when this thread's
// copies so far have landed
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// orders this thread's shared-memory accesses before the async proxy's
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// the descriptor of a 128-byte-swizzled operand at shared address `addr`
// (1,024-byte aligned tile, plus the k-step's offset): SBO 1,024 bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// k-step kk of rows [row0, row0 + 64) of a tile of R rows at `tile`, read
// K-major
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int R, int row0,
                                                int kk) {
  return desc_sw128(tile + (kk >> 2) * R * 128 + row0 * 128 + (kk & 3) * 32,
                    16);
}

// k-step kk (rows [16 kk, 16 kk + 16)) of columns [64 c, 64 c + 64) of a
// tile of R rows at `tile`, read MN-major
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int R, int c,
                                                 int kk) {
  return desc_sw128(tile + c * R * 128 + kk * 2048, R * 128);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous products that own it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_F8(b)                                                   \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),          \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (m64 x N, f32) = (acc ? d : 0) + A B: A [64][16] and B [16][N] bf16
// from shared memory (A K-major; B K-major, or MN-major when TB)
template <int N, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int acc) {
  static_assert(N == 64 || N == 32, "wgmma_ss: N 32 or 64");
  if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n"
        "}\n"
        : HOPPER_F8(0), HOPPER_F8(8), HOPPER_F8(16), HOPPER_F8(24)
        : "l"(da), "l"(db), "r"(acc), "n"(TB));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p, 1, 1, 0, %19;\n"
        "}\n"
        : HOPPER_F8(0), HOPPER_F8(8)
        : "l"(da), "l"(db), "r"(acc), "n"(TB));
  }
}

// d (m64 x 64, f32) = (acc ? d : 0) + A B: A [64][16] bf16 from registers
// (the m16n8k16 A fragment of each warp's 16 rows), B [16][64] bf16 from
// shared memory (K-major, or MN-major when TB)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : HOPPER_F8(0), HOPPER_F8(8), HOPPER_F8(16), HOPPER_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
        "n"(TB));
}

#undef HOPPER_F8

// ---------------------------------------------------------------------------
// registers
// ---------------------------------------------------------------------------

// this warpgroup's register count a thread, raised or lowered to R (all
// four warps execute it)
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// tensor maps (host)
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the CUDA driver API's cuTensorMapEncodeTiled, reached through the runtime
static inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
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
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of x [B, S, H, D] bf16 (contiguous, 16-byte aligned) in boxes of
// [rows][64] at one (b, h): 128-byte swizzle, zeros past D and past S.
// Returns a CUDA error code (0: encoded).
static inline int tile_map(CUtensorMap* map, const void* x, int B, int S,
                           int H, int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t e = 2;  // bytes a bf16
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {e * D, e * D * H, e * D * H * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(x), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper
