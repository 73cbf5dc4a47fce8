// Backward of the blocked-ELL SpMM for Hopper (sm_90a), f32: the values'
// cotangent.
//
// For out[p, i, :] = sum_k vals[p, i, k] * h[p, cols[p, i, k], :] and the
// output's cotangent g [p, n_rows, d]:
//
//   d_vals[p, i, k] = <g[p, i, :], h[p, cols[p, i, k], :]>
//
// This is the `d_vals` half of the custom-VJP backward `_spmm_vjp.bwd` of
// src/repro/kernels/ell_spmm.py (lines 80-92), which the TPU package leaves
// to XLA as a gather + einsum around the Pallas forward kernel
// `_ell_spmm_raw` (line 116).  The other half, d_h = A^T g, is
// csr_spmm.cu's write mode over the transposed pack.
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

#include "on_device.cuh"

namespace {

constexpr int kWarps = 8;

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

// cols int32 [n_parts, n_rows, k_slots]; g f32 [n_parts, n_rows, d]; h f32
// [n_parts, n_cols, d]; dvals f32 [n_parts, n_rows, k_slots]; all
// contiguous.  Launches on `device` and `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int ell_spmm_dvals_f32(const void* cols, const void* g,
                                  const void* h, void* dvals, int n_parts,
                                  int n_rows, int k_slots, int n_cols, int d,
                                  long long slot_stride, long long g_stride,
                                  long long h_stride, int device,
                                  void* stream) {
  return on_device(device, [&] {
    const dim3 grid((n_rows + kWarps - 1) / kWarps, 1, n_parts);
    ell_spmm_dvals_kernel<<<grid, kWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(cols), static_cast<const float*>(g),
        static_cast<const float*>(h), static_cast<float*>(dvals), n_rows,
        k_slots, n_cols, d, slot_stride, g_stride, h_stride);
    return static_cast<int>(cudaGetLastError());
  });
}
