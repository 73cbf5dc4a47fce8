// Blocked-ELL SpMM for Hopper (sm_90a), f32.
//
//   out[p, i, :] = sum_k vals[p, i, k] * h[p, cols[p, i, k], :]
//
// Replaces the TPU kernel `_ell_spmm_raw` of src/repro/kernels/ell_spmm.py
// (the grid case: the pallas_call at line 116 running `_zero_init_kernel`
// and `_kernel`).  Sums are kept in f32 registers, as there.
//
// What bounds it on the H100: bytes.  Each nonzero slot reads one h row
// (d * 4 bytes) for 2 * d flops, 0.5 flop per byte, far below the f32
// ridge of 67 TFLOP/s over 3.35 TB/s.  The TPU kernel kept a whole
// n_cols x 128 stripe of h resident in VMEM; on the flickr serving slice
// that stripe is 67,806 x 128 x 4 B = 35 MB, far beyond the 227 KB of
// shared memory a block can have, so this kernel reads h rows from HBM
// through the 50 MB L2 instead.  What the design does about the bytes:
//  - a block owns 32 rows; it stages their ELL slots (cols, vals) through
//    shared memory in chunks of 32 slots with coalesced loads, and walks
//    the slots of each row in order;
//  - a feature block covers up to 512 columns (4, 8 or 16 per lane), so
//    at the slice's widths (500 and 256) every slot is read exactly once;
//  - padding slots (val == 0; 95% of the slots of the slice's hybrid pack)
//    are skipped with a warp ballot: they cost their 8 staged bytes and no
//    h traffic;
//  - a warp owns whole rows and its lanes cover neighbouring feature
//    columns, so every h-row read is a run of 128-byte coalesced segments;
//  - ragged row and feature edges are masked here, so the caller makes no
//    padded copies of h or out.
// The partition is the grid's z dimension: one launch covers all P
// partitions of the stacked [P, NI, K] / [P, NI + NH, d] layout.
// A slot whose column lies outside [0, n_cols) contributes nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;  // 32
constexpr int kSlotChunk = 32;                        // one slot per lane

template <int FPL>  // feature columns per lane
__global__ void __launch_bounds__(kWarps * 32)
ell_spmm_f32_kernel(const int32_t* __restrict__ cols,
                    const float* __restrict__ vals,
                    const float* __restrict__ h, float* __restrict__ out,
                    int n_rows, int k_slots, int n_cols, int d,
                    int64_t slot_stride, int64_t h_stride,
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
      unsigned live = __ballot_sync(0xffffffffu, s_vals[r][lane] != 0.f);
      while (live) {
        const int t = __ffs(live) - 1;
        live &= live - 1;
        const int c = s_cols[r][t];
        if (c < 0 || c >= n_cols) continue;
        const float v = s_vals[r][t];
        const float* hrow = h + static_cast<int64_t>(c) * d;
#pragma unroll
        for (int j = 0; j < FPL; ++j) {
          const int f = f0 + lane + 32 * j;
          if (f < d) acc[rr][j] = fmaf(v, __ldg(hrow + f), acc[rr][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + warp * kRowsPerWarp + rr;
    if (row >= n_rows) continue;
    float* orow = out + static_cast<int64_t>(row) * d;
#pragma unroll
    for (int j = 0; j < FPL; ++j) {
      const int f = f0 + lane + 32 * j;
      if (f < d) orow[f] = acc[rr][j];
    }
  }
}

template <int FPL>
void launch(const int32_t* cols, const float* vals, const float* h,
            float* out, int n_parts, int n_rows, int k_slots, int n_cols,
            int d, int64_t slot_stride, int64_t h_stride, int64_t out_stride,
            cudaStream_t stream) {
  const dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock,
                  (d + 32 * FPL - 1) / (32 * FPL), n_parts);
  ell_spmm_f32_kernel<FPL><<<grid, kWarps * 32, 0, stream>>>(
      cols, vals, h, out, n_rows, k_slots, n_cols, d, slot_stride, h_stride,
      out_stride);
}

}  // namespace

// cols int32 and vals f32 [n_parts, n_rows, k_slots]; h f32
// [n_parts, n_cols, d]; out f32 [n_parts, n_rows, d]; all contiguous, with
// the per-partition strides given in elements.  Returns cudaGetLastError().
extern "C" int ell_spmm_f32(const void* cols, const void* vals, const void* h,
                            void* out, int n_parts, int n_rows, int k_slots,
                            int n_cols, int d, long long slot_stride,
                            long long h_stride, long long out_stride,
                            void* stream) {
  auto c = static_cast<const int32_t*>(cols);
  auto v = static_cast<const float*>(vals);
  auto x = static_cast<const float*>(h);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (d <= 128) {
    launch<4>(c, v, x, o, n_parts, n_rows, k_slots, n_cols, d, slot_stride,
              h_stride, out_stride, s);
  } else if (d <= 256) {
    launch<8>(c, v, x, o, n_parts, n_rows, k_slots, n_cols, d, slot_stride,
              h_stride, out_stride, s);
  } else {
    launch<16>(c, v, x, o, n_parts, n_rows, k_slots, n_cols, d, slot_stride,
               h_stride, out_stride, s);
  }
  return static_cast<int>(cudaGetLastError());
}
