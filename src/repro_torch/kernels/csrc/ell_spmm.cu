// Blocked-ELL SpMM for Hopper (sm_90a): f32 or bf16 h, f32 sums.
//
//   out[p, i, :] = sum_k vals[p, i, k] * h[p, cols[p, i, k], :]
//
// Replaces the TPU kernel `_ell_spmm_raw` of src/repro/kernels/ell_spmm.py:
// its grid case (the pallas_call at line 116 running `_zero_init_kernel`
// and `_kernel`) and its column-chunked case (`chunk_kernel`, the
// pallas_call at line 154), through one kernel template: col_chunk == n_cols
// is the grid case, a smaller col_chunk walks the h rows in chunks of that
// many rows, each chunk adding only the slots whose column lies in it.
// Sums are kept in f32 registers, as there; the output has h's type.
//
// What bounds it on the H100: bytes.  Each live slot reads one h row
// (d * 4 bytes in f32, d * 2 in bf16) for 2 * d flops, at most 0.5 flop
// per byte, far below the f32 ridge of 67 TFLOP/s over 3.35 TB/s; tensor
// cores do not apply.  The least traffic reads each h row that a live slot
// names once; the kernel reads one h row per live slot (7.5x as many bytes
// on the flickr serving pack at d = 500), so it lives on L2 hits and on
// how many bytes it keeps in flight.  The TPU kernel kept an n_cols x 128
// stripe of h in VMEM (35 MB on that pack); a block here has 227 KB of
// shared memory, so the stripe is mapped onto the 50 MB L2 instead:
//  - one warp per ELL row, no shared memory and no block barrier: a warp
//    walks its own row and never waits for a heavier row of its block
//    (the degrees are power-law: one row of a block may hold 100 live
//    slots while its neighbours hold 2);
//  - the row's slots are read 32 at a time, one per lane, coalesced, only
//    up to the row's last live slot (`row_end`, computed once from the
//    constant pack; the stacked hybrid packs are 92-95% padding), and the
//    padding slots below it are skipped with a warp ballot: they cost
//    their 8 read bytes and no h traffic.  Without row_end every slot is
//    read;
//  - the h reads are VEC-element vector loads (16 bytes where the row
//    width and the base addresses allow, else 8, 4 or 2), LPS lanes per
//    slot, each with NV vectors, so a warp takes 32 / LPS slots at a time;
//    kUnroll (2) such steps issue their loads before their FMAs, 64 / LPS
//    live slots in flight per warp (4 steps lost to 2 on the H100: more
//    registers, fewer warps per SM);
//  - the feature columns are cut into stripes of LPS * NV * VEC columns,
//    the grid's y axis, with the partition (z) outside it and the rows (x)
//    inside: the blocks in flight share one partition's stripe of h, which
//    is what the L2 has to hold, at the cost of reading each row's slots
//    once per stripe;
//  - ragged row and feature edges are masked here, so the caller makes no
//    padded copies of h or out.
// The column chunks were the TPU kernel's way to fit h into its 16 MiB VMEM
// budget; here they only order the sums as the chunked kernel does (each
// warp re-reads its row's slots per chunk, from L1).
// A slot whose column lies outside [0, n_cols) contributes nothing.
// The host picks VEC and the stripe (kernels/ell_spmm.py:
// `ell_launch_config`) and the C entry point maps them onto the template.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "on_device.cuh"

namespace {

constexpr int kWarps = 4;   // rows per block, one per warp
constexpr int kUnroll = 2;  // slot steps loaded before their FMAs
constexpr unsigned kFull = 0xffffffffu;

// VEC elements of T moved as one word
template <typename T, int VEC> struct Word;
template <> struct Word<float, 4> { using type = float4; };
template <> struct Word<float, 2> { using type = float2; };
template <> struct Word<float, 1> { using type = float; };
template <> struct Word<__nv_bfloat16, 8> { using type = uint4; };
template <> struct Word<__nv_bfloat16, 4> { using type = uint2; };
template <> struct Word<__nv_bfloat16, 2> { using type = unsigned int; };
template <> struct Word<__nv_bfloat16, 1> { using type = unsigned short; };

template <typename T, int VEC>
using word_t = typename Word<T, VEC>::type;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __float2bfloat16(x);
  }
}

// acc[i] += v * (the i-th element of w), in f32
template <typename T, int VEC>
__device__ __forceinline__ void fma_word(float v, const word_t<T, VEC>& w,
                                         float (&acc)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = fmaf(v, to_f32(e[i]), acc[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_word(T* p, const float (&x)[VEC]) {
  word_t<T, VEC> w;
  T* e = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(x[i]);
  *reinterpret_cast<word_t<T, VEC>*>(p) = w;
}

// T: the type of h and out.  VEC: elements per load.  LPS: lanes per slot
// (16 or 32).  NV: vectors per lane.  A warp's stripe is LPS * NV * VEC
// feature columns.
template <typename T, int VEC, int LPS, int NV>
__global__ void __launch_bounds__(kWarps * 32)
ell_spmm_kernel(const int32_t* __restrict__ cols,
                const float* __restrict__ vals,
                const int32_t* __restrict__ row_end,
                const T* __restrict__ h, T* __restrict__ out, int n_rows,
                int k_slots, int n_cols, int d, int col_chunk,
                int64_t slot_stride, int64_t h_stride, int64_t out_stride) {
  constexpr int G = 32 / LPS;   // slots a warp takes at a time
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;    // warp-uniform
  const int64_t part = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int sub = lane / LPS;   // which of the G slots this lane serves
  const int sl = lane % LPS;

  const int64_t slot0 = part * slot_stride + static_cast<int64_t>(row) * k_slots;
  const int32_t* rc = cols + slot0;
  const float* rv = vals + slot0;
  const T* hp = h + part * h_stride;
  const int end =
      row_end ? min(__ldg(row_end + part * n_rows + row), k_slots) : k_slots;

  int fcol[NV];
  bool fok[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    fcol[j] = blockIdx.y * (LPS * NV * VEC) + (sl + j * LPS) * VEC;
    fok[j] = fcol[j] < d;   // d % VEC == 0: a vector is all in or all out
  }
  float acc[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;

  for (int lo = 0; lo < n_cols; lo += col_chunk) {
    const int hi = lo + min(col_chunk, n_cols - lo);
    for (int k0 = 0; k0 < end; k0 += 32) {
      const int k = k0 + lane;
      int c = 0;
      float v = 0.f;
      if (k < end) {
        c = __ldg(rc + k);
        v = __ldg(rv + k);
      }
      unsigned live = __ballot_sync(kFull, v != 0.f && c >= lo && c < hi);
      while (live) {
        int cs[kUnroll];
        float vs[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          // pop G live slots (warp-uniform); this lane's group takes one
          int t = -1;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const int b = __ffs(live) - 1;   // -1 once none is left
            live &= live - 1;
            if (g == sub) t = b;
          }
          const int src = t < 0 ? 0 : t;
          cs[u] = __shfl_sync(kFull, c, src);
          const float vt = __shfl_sync(kFull, v, src);
          vs[u] = t < 0 ? 0.f : vt;
        }
        // all kUnroll steps' loads first (raw words: a bf16 word holds VEC
        // values in VEC / 2 registers), then their FMAs
        word_t<T, VEC> x[kUnroll][NV];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const T* hrow = hp + static_cast<int64_t>(cs[u]) * d;
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            x[u][j] = vs[u] != 0.f && fok[j]
                          ? __ldg(reinterpret_cast<const word_t<T, VEC>*>(
                                hrow + fcol[j]))
                          : word_t<T, VEC>{};
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int j = 0; j < NV; ++j) fma_word<T, VEC>(vs[u], x[u][j], acc[j]);
      }
    }
  }

  // the G groups hold partial sums of one row: add them up
#pragma unroll
  for (int off = LPS; off < 32; off <<= 1)
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[j][e] += __shfl_xor_sync(kFull, acc[j][e], off);
  if (sub != 0) return;
  T* orow = out + part * out_stride + static_cast<int64_t>(row) * d;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (fok[j]) store_word<T, VEC>(orow + fcol[j], acc[j]);
}

struct Args {
  const void* cols;
  const void* vals;
  const void* row_end;
  const void* h;
  void* out;
  int n_parts, n_rows, k_slots, n_cols, d, col_chunk;
  long long slot_stride, h_stride, out_stride;
  cudaStream_t stream;
};

template <typename T, int VEC, int LPS, int NV>
int launch(const Args& a) {
  constexpr int kStripe = LPS * NV * VEC;
  const dim3 grid((a.n_rows + kWarps - 1) / kWarps,
                  (a.d + kStripe - 1) / kStripe, a.n_parts);
  ell_spmm_kernel<T, VEC, LPS, NV><<<grid, kWarps * 32, 0, a.stream>>>(
      static_cast<const int32_t*>(a.cols), static_cast<const float*>(a.vals),
      static_cast<const int32_t*>(a.row_end), static_cast<const T*>(a.h),
      static_cast<T*>(a.out), a.n_rows, a.k_slots, a.n_cols, a.d,
      a.col_chunk, a.slot_stride, a.h_stride, a.out_stride);
  return static_cast<int>(cudaGetLastError());
}

// stripe_vectors: vectors per warp row stripe, LPS * NV
template <typename T, int VEC>
int by_stripe(const Args& a, int stripe_vectors) {
  switch (stripe_vectors) {
    case 16: return launch<T, VEC, 16, 1>(a);
    case 32: return launch<T, VEC, 32, 1>(a);
    case 64: return launch<T, VEC, 32, 2>(a);
    case 128: return launch<T, VEC, 32, 4>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// cols int32 and vals f32 [n_parts, n_rows, k_slots]; row_end int32
// [n_parts, n_rows] (one past each row's last live slot) or null; h and out
// of one type (f32 or bf16) [n_parts, n_cols, d] and [n_parts, n_rows, d];
// all contiguous, with the per-partition strides given in elements.
// col_chunk in [1, n_cols] (n_cols: no chunks).  vec (elements per load:
// 1, 2, 4, and 8 for bf16) must divide d and keep h and out aligned;
// stripe_vectors in {16, 32, 64, 128}.  Launches on `device` and `stream`;
// returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a configuration it does not take.
extern "C" int ell_spmm_f32(const void* cols, const void* vals,
                            const void* row_end, const void* h, void* out,
                            int n_parts, int n_rows, int k_slots, int n_cols,
                            int d, int col_chunk, long long slot_stride,
                            long long h_stride, long long out_stride, int vec,
                            int stripe_vectors, int device, void* stream) {
  const Args a{cols, vals, row_end, h, out, n_parts, n_rows, k_slots, n_cols,
               d, col_chunk, slot_stride, h_stride, out_stride,
               static_cast<cudaStream_t>(stream)};
  return on_device(device, [&] {
    switch (vec) {
      case 4: return by_stripe<float, 4>(a, stripe_vectors);
      case 2: return by_stripe<float, 2>(a, stripe_vectors);
      case 1: return by_stripe<float, 1>(a, stripe_vectors);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

extern "C" int ell_spmm_bf16(const void* cols, const void* vals,
                             const void* row_end, const void* h, void* out,
                             int n_parts, int n_rows, int k_slots,
                             int n_cols, int d, int col_chunk,
                             long long slot_stride, long long h_stride,
                             long long out_stride, int vec,
                             int stripe_vectors, int device, void* stream) {
  const Args a{cols, vals, row_end, h, out, n_parts, n_rows, k_slots, n_cols,
               d, col_chunk, slot_stride, h_stride, out_stride,
               static_cast<cudaStream_t>(stream)};
  return on_device(device, [&] {
    switch (vec) {
      case 8: return by_stripe<__nv_bfloat16, 8>(a, stripe_vectors);
      case 4: return by_stripe<__nv_bfloat16, 4>(a, stripe_vectors);
      case 2: return by_stripe<__nv_bfloat16, 2>(a, stripe_vectors);
      case 1: return by_stripe<__nv_bfloat16, 1>(a, stripe_vectors);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}
