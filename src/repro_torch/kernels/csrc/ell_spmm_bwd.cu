// Backward of the blocked-ELL SpMM for Hopper (sm_90a), f32.
//
// For out[p, i, :] = sum_k vals[p, i, k] * h[p, cols[p, i, k], :] and the
// output's cotangent g [p, n_rows, d]:
//
//   d_h[p, c, :]    = sum over slots (i, k) with cols[p, i, k] == c of
//                     vals[p, i, k] * g[p, i, :]                (A^T g)
//   d_vals[p, i, k] = <g[p, i, :], h[p, cols[p, i, k], :]>
//
// These replace the custom-VJP backward `_spmm_vjp.bwd` of
// src/repro/kernels/ell_spmm.py (lines 80-92), which the TPU package
// leaves to XLA as a jnp scatter-add (d_h) and a gather + einsum (d_vals)
// around the Pallas forward kernel `_ell_spmm_raw` (line 116).
//
// ell_spmm_dh_f32: what bounds it on the H100 is bytes (2 flops per live
// slot and column against 8 bytes of atomic traffic).  The least it must
// move is cols + vals, g and d_h once each; on the training slice at
// d = 256 that is 84 MB + 100 MB + 201 MB, about 0.12 ms at 3.35 TB/s.
// Design: one warp per ELL row, its lanes over neighbouring feature
// columns; the row of g sits in registers, the row's slots are read 32 at
// a time (one per lane, coalesced), padding slots (val == 0, 92% of the
// slice's hybrid pack) are skipped with a warp ballot, and each live slot
// adds vals * g[row] into the d_h row it names with f32 atomicAdd (one
// coalesced 128-byte reduction per warp instruction, resolved in L2).
// The alternative, a transposed ELL pack built at stack time and run
// through the forward kernel (the comment at ell_spmm.py:85-87), needs no
// atomics but a second pack per partition: the column degrees of the
// partitions' local graphs are as skewed as the row degrees, so it would
// need its own COO tail and a second tail pass, and twice the pack memory.
// The atomics reuse the forward pack as it is.  Their order changes from
// run to run, so d_h is not bit-reproducible; it agrees with the plain
// version within f32 rounding of the sums.  The caller zeroes d_h.
//
// ell_spmm_dvals_f32: one warp per ELL row, a dot product of g[row] with
// h[cols] for every slot (the reference's einsum covers padding slots too,
// whose column is 0), reduced across the warp with shuffles; slots whose
// column lies outside [0, n_cols) get 0.  It reads one h row per slot and
// is bound by those bytes.  No path of the port needs it today (the ELL
// values are constants of the graph); it completes the VJP.
//
// The partition is the grid's z dimension, as in the forward kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;  // 32

template <int FPL>  // feature columns per lane
__global__ void __launch_bounds__(kWarps * 32)
ell_spmm_dh_kernel(const int32_t* __restrict__ cols,
                   const float* __restrict__ vals,
                   const float* __restrict__ g, float* __restrict__ dh,
                   int n_rows, int k_slots, int n_cols, int d,
                   int64_t slot_stride, int64_t g_stride, int64_t dh_stride) {
  const int64_t part = blockIdx.z;
  const int f0 = blockIdx.y * (32 * FPL);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  cols += part * slot_stride;
  vals += part * slot_stride;
  g += part * g_stride;
  dh += part * dh_stride;

  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp + rr;
    if (row >= n_rows) break;  // warp-uniform
    float gv[FPL];
    const float* grow = g + static_cast<int64_t>(row) * d;
#pragma unroll
    for (int j = 0; j < FPL; ++j) {
      const int f = f0 + lane + 32 * j;
      gv[j] = f < d ? __ldg(grow + f) : 0.f;
    }
    const int64_t base = static_cast<int64_t>(row) * k_slots;
    for (int k0 = 0; k0 < k_slots; k0 += 32) {
      const int slot = k0 + lane;
      const int c = slot < k_slots ? __ldg(cols + base + slot) : 0;
      const float v = slot < k_slots ? __ldg(vals + base + slot) : 0.f;
      unsigned live =
          __ballot_sync(0xffffffffu, v != 0.f && c >= 0 && c < n_cols);
      while (live) {
        const int t = __ffs(live) - 1;
        live &= live - 1;
        const int ct = __shfl_sync(0xffffffffu, c, t);
        const float vt = __shfl_sync(0xffffffffu, v, t);
        float* drow = dh + static_cast<int64_t>(ct) * d;
#pragma unroll
        for (int j = 0; j < FPL; ++j) {
          const int f = f0 + lane + 32 * j;
          if (f < d) atomicAdd(drow + f, vt * gv[j]);
        }
      }
    }
  }
}

template <int FPL>
void launch_dh(const void* cols, const void* vals, const void* g, void* dh,
               int n_parts, int n_rows, int k_slots, int n_cols, int d,
               int64_t slot_stride, int64_t g_stride, int64_t dh_stride,
               cudaStream_t stream) {
  const dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock,
                  (d + 32 * FPL - 1) / (32 * FPL), n_parts);
  ell_spmm_dh_kernel<FPL><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const int32_t*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(g), static_cast<float*>(dh), n_rows, k_slots,
      n_cols, d, slot_stride, g_stride, dh_stride);
}

__global__ void __launch_bounds__(kWarps * 32)
ell_spmm_dvals_kernel(const int32_t* __restrict__ cols,
                      const float* __restrict__ g,
                      const float* __restrict__ h, float* __restrict__ dvals,
                      int n_rows, int k_slots, int n_cols, int d,
                      int64_t slot_stride, int64_t g_stride,
                      int64_t h_stride) {
  const int64_t part = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= n_rows) return;  // warp-uniform

  cols += part * slot_stride;
  dvals += part * slot_stride;
  g += part * g_stride;
  h += part * h_stride;

  const float* grow = g + static_cast<int64_t>(row) * d;
  const int64_t base = static_cast<int64_t>(row) * k_slots;
  for (int k0 = 0; k0 < k_slots; k0 += 32) {
    const int slot = k0 + lane;
    const int c = slot < k_slots ? __ldg(cols + base + slot) : 0;
    const int n = min(32, k_slots - k0);
    float mine = 0.f;
    for (int t = 0; t < n; ++t) {
      const int ct = __shfl_sync(0xffffffffu, c, t);
      float s = 0.f;
      if (ct >= 0 && ct < n_cols) {
        const float* hrow = h + static_cast<int64_t>(ct) * d;
        for (int f = lane; f < d; f += 32)
          s = fmaf(__ldg(grow + f), __ldg(hrow + f), s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == t) mine = s;
    }
    if (slot < k_slots) dvals[base + slot] = mine;
  }
}

}  // namespace

// cols int32 and vals f32 [n_parts, n_rows, k_slots]; g f32
// [n_parts, n_rows, d]; dh f32 [n_parts, n_cols, d], zeroed by the caller;
// all contiguous, with the per-partition strides given in elements.
// Returns cudaGetLastError() after the launch.
extern "C" int ell_spmm_dh_f32(const void* cols, const void* vals,
                               const void* g, void* dh, int n_parts,
                               int n_rows, int k_slots, int n_cols, int d,
                               long long slot_stride, long long g_stride,
                               long long dh_stride, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (d <= 128) {
    launch_dh<4>(cols, vals, g, dh, n_parts, n_rows, k_slots, n_cols, d,
                 slot_stride, g_stride, dh_stride, s);
  } else if (d <= 256) {
    launch_dh<8>(cols, vals, g, dh, n_parts, n_rows, k_slots, n_cols, d,
                 slot_stride, g_stride, dh_stride, s);
  } else {
    launch_dh<16>(cols, vals, g, dh, n_parts, n_rows, k_slots, n_cols, d,
                  slot_stride, g_stride, dh_stride, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// cols int32 [n_parts, n_rows, k_slots]; g f32 [n_parts, n_rows, d]; h f32
// [n_parts, n_cols, d]; dvals f32 [n_parts, n_rows, k_slots]; all
// contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int ell_spmm_dvals_f32(const void* cols, const void* g,
                                  const void* h, void* dvals, int n_parts,
                                  int n_rows, int k_slots, int n_cols, int d,
                                  long long slot_stride, long long g_stride,
                                  long long h_stride, void* stream) {
  const dim3 grid((n_rows + kWarps - 1) / kWarps, 1, n_parts);
  ell_spmm_dvals_kernel<<<grid, kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), static_cast<const float*>(g),
      static_cast<const float*>(h), static_cast<float*>(dvals), n_rows,
      k_slots, n_cols, d, slot_stride, g_stride, h_stride);
  return static_cast<int>(cudaGetLastError());
}
