// Blocked-ELL SpMM for Hopper (sm_90a): f32 or bf16 h, f32 sums.
//
//   out[p, i, :] = sum_k vals[p, i, k] * h[p, cols[p, i, k], :]
//
// Two entry points over one kernel template:
//  - ell_spmm_{f32,bf16} replace the TPU kernel `_ell_spmm_raw` of
//    src/repro/kernels/ell_spmm.py (the grid case: the pallas_call at line
//    116 running `_zero_init_kernel` and `_kernel`);
//  - ell_spmm_chunked_{f32,bf16} replace its column-chunked case
//    (`chunk_kernel`, the pallas_call at line 154): the h rows are walked
//    in chunks of `col_chunk`, and each chunk accumulates only the slots
//    whose column lies in it.
// Sums are kept in f32 registers, as there; the output has h's type.
//
// What bounds it on the H100: bytes.  Each nonzero slot reads one h row
// (d * 4 bytes in f32, d * 2 in bf16) for 2 * d flops, at most 0.5 flop
// per byte, far below the f32 ridge of 67 TFLOP/s over 3.35 TB/s.  The TPU
// kernel kept a whole n_cols x 128 stripe of h resident in VMEM; on the
// flickr serving slice that stripe is 67,806 x 128 x 4 B = 35 MB, far
// beyond the 227 KB of shared memory a block can have, so this kernel reads
// h rows from HBM through the 50 MB L2 instead.  What the design does about
// the bytes:
//  - a block owns 32 rows; it stages their ELL slots (cols, vals) through
//    shared memory in chunks of 32 slots with coalesced loads, and walks
//    the slots of each row in order;
//  - a feature block covers up to 512 columns (4, 8 or 16 per lane), so
//    at the slices' widths (500 and 256) every slot is read exactly once;
//  - padding slots (val == 0; 92-95% of the slots of the slices' hybrid
//    packs) are skipped with a warp ballot: they cost their 8 staged bytes
//    and no h traffic;
//  - a warp owns whole rows and its lanes cover neighbouring feature
//    columns, so every h-row read is a run of coalesced segments;
//  - ragged row and feature edges are masked here, so the caller makes no
//    padded copies of h or out.
// The column chunks were the TPU kernel's way to fit h into its 16 MiB
// VMEM budget.  Here they are an L2-locality tiling: the blocks in flight
// walk the chunks in the same order, so while they work on one chunk its
// h rows (col_chunk * d * 4 bytes; 8 MB at 8192 x 256) are what the L2
// holds.  Each chunk re-stages the block's slots (cols, vals, from L2) and
// reads every live h row exactly once over all chunks, so the h traffic
// equals the unchunked kernel's.
// The partition is the grid's z dimension: one launch covers all P
// partitions of the stacked [P, NI, K] / [P, NI + NH, d] layout.
// A slot whose column lies outside [0, n_cols) contributes nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;  // 32
constexpr int kSlotChunk = 32;                        // one slot per lane

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// T: the type of h and out.  FPL: feature columns per lane.  CHUNKED: walk
// the h rows in chunks of col_chunk (otherwise one pass over all of them).
template <typename T, int FPL, bool CHUNKED>
__global__ void __launch_bounds__(kWarps * 32)
ell_spmm_kernel(const int32_t* __restrict__ cols,
                const float* __restrict__ vals, const T* __restrict__ h,
                T* __restrict__ out, int n_rows, int k_slots, int n_cols,
                int d, int col_chunk, int64_t slot_stride, int64_t h_stride,
                int64_t out_stride) {
  __shared__ int32_t s_cols[kRowsPerBlock][kSlotChunk];
  __shared__ float s_vals[kRowsPerBlock][kSlotChunk];

  const int64_t part = blockIdx.z;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int f0 = blockIdx.y * (32 * FPL);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  cols += part * slot_stride;
  vals += part * slot_stride;
  h += part * h_stride;
  out += part * out_stride;

  float acc[kRowsPerWarp][FPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int j = 0; j < FPL; ++j) acc[rr][j] = 0.f;

  const int step = CHUNKED ? col_chunk : n_cols;
  for (int lo = 0; lo < n_cols; lo += step) {
    const int hi = CHUNKED ? min(lo + col_chunk, n_cols) : n_cols;
    for (int k0 = 0; k0 < k_slots; k0 += kSlotChunk) {
      for (int i = threadIdx.x; i < kRowsPerBlock * kSlotChunk;
           i += blockDim.x) {
        const int r = i / kSlotChunk;
        const int k = i % kSlotChunk;
        const int row = row0 + r;
        const int slot = k0 + k;
        const bool ok = row < n_rows && slot < k_slots;
        const int64_t at = static_cast<int64_t>(row) * k_slots + slot;
        s_cols[r][k] = ok ? cols[at] : 0;
        s_vals[r][k] = ok ? vals[at] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr;
        // live: a nonzero slot whose column lies in this chunk (in
        // [0, n_cols) for the unchunked kernel)
        const int c_lane = s_cols[r][lane];
        unsigned live = __ballot_sync(
            0xffffffffu, s_vals[r][lane] != 0.f && c_lane >= lo && c_lane < hi);
        while (live) {
          const int t = __ffs(live) - 1;
          live &= live - 1;
          const int c = s_cols[r][t];
          const float v = s_vals[r][t];
          const T* hrow = h + static_cast<int64_t>(c) * d;
#pragma unroll
          for (int j = 0; j < FPL; ++j) {
            const int f = f0 + lane + 32 * j;
            if (f < d) acc[rr][j] = fmaf(v, load_f32(hrow + f), acc[rr][j]);
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + warp * kRowsPerWarp + rr;
    if (row >= n_rows) continue;
    T* orow = out + static_cast<int64_t>(row) * d;
#pragma unroll
    for (int j = 0; j < FPL; ++j) {
      const int f = f0 + lane + 32 * j;
      if (f < d) store_f32(orow + f, acc[rr][j]);
    }
  }
}

template <typename T, int FPL, bool CHUNKED>
void launch(const void* cols, const void* vals, const void* h, void* out,
            int n_parts, int n_rows, int k_slots, int n_cols, int d,
            int col_chunk, int64_t slot_stride, int64_t h_stride,
            int64_t out_stride, cudaStream_t stream) {
  const dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock,
                  (d + 32 * FPL - 1) / (32 * FPL), n_parts);
  ell_spmm_kernel<T, FPL, CHUNKED><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const int32_t*>(cols), static_cast<const float*>(vals),
      static_cast<const T*>(h), static_cast<T*>(out), n_rows, k_slots,
      n_cols, d, col_chunk, slot_stride, h_stride, out_stride);
}

template <typename T, bool CHUNKED>
int dispatch(const void* cols, const void* vals, const void* h, void* out,
             int n_parts, int n_rows, int k_slots, int n_cols, int d,
             int col_chunk, long long slot_stride, long long h_stride,
             long long out_stride, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (d <= 128) {
    launch<T, 4, CHUNKED>(cols, vals, h, out, n_parts, n_rows, k_slots,
                          n_cols, d, col_chunk, slot_stride, h_stride,
                          out_stride, s);
  } else if (d <= 256) {
    launch<T, 8, CHUNKED>(cols, vals, h, out, n_parts, n_rows, k_slots,
                          n_cols, d, col_chunk, slot_stride, h_stride,
                          out_stride, s);
  } else {
    launch<T, 16, CHUNKED>(cols, vals, h, out, n_parts, n_rows, k_slots,
                           n_cols, d, col_chunk, slot_stride, h_stride,
                           out_stride, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cols int32 and vals f32 [n_parts, n_rows, k_slots]; h and out of one
// type (f32 or bf16) [n_parts, n_cols, d] and [n_parts, n_rows, d]; all
// contiguous, with the per-partition strides given in elements.  The
// chunked entry points take col_chunk >= 1.  Each returns
// cudaGetLastError() after its launch.
extern "C" int ell_spmm_f32(const void* cols, const void* vals, const void* h,
                            void* out, int n_parts, int n_rows, int k_slots,
                            int n_cols, int d, long long slot_stride,
                            long long h_stride, long long out_stride,
                            void* stream) {
  return dispatch<float, false>(cols, vals, h, out, n_parts, n_rows, k_slots,
                                n_cols, d, n_cols, slot_stride, h_stride,
                                out_stride, stream);
}

extern "C" int ell_spmm_bf16(const void* cols, const void* vals,
                             const void* h, void* out, int n_parts,
                             int n_rows, int k_slots, int n_cols, int d,
                             long long slot_stride, long long h_stride,
                             long long out_stride, void* stream) {
  return dispatch<__nv_bfloat16, false>(cols, vals, h, out, n_parts, n_rows,
                                        k_slots, n_cols, d, n_cols,
                                        slot_stride, h_stride, out_stride,
                                        stream);
}

extern "C" int ell_spmm_chunked_f32(const void* cols, const void* vals,
                                    const void* h, void* out, int n_parts,
                                    int n_rows, int k_slots, int n_cols,
                                    int d, int col_chunk,
                                    long long slot_stride, long long h_stride,
                                    long long out_stride, void* stream) {
  return dispatch<float, true>(cols, vals, h, out, n_parts, n_rows, k_slots,
                               n_cols, d, col_chunk, slot_stride, h_stride,
                               out_stride, stream);
}

extern "C" int ell_spmm_chunked_bf16(const void* cols, const void* vals,
                                     const void* h, void* out, int n_parts,
                                     int n_rows, int k_slots, int n_cols,
                                     int d, int col_chunk,
                                     long long slot_stride,
                                     long long h_stride,
                                     long long out_stride, void* stream) {
  return dispatch<__nv_bfloat16, true>(cols, vals, h, out, n_parts, n_rows,
                                       k_slots, n_cols, d, col_chunk,
                                       slot_stride, h_stride, out_stride,
                                       stream);
}
