// Backward of the blocked-ELL SpMM for Hopper (sm_90a), f32: the values'
// cotangent.
//
// For out[p, i, :] = sum_k vals[p, i, k] * h[p, cols[p, i, k], :] and the
// output's cotangent g [p, n_rows, d]:
//
//   d_vals[p, i, k] = <g[p, i, :], h[p, cols[p, i, k], :]>
//
// for every slot, padding included (the reference's einsum covers them;
// their column is 0).  This is the `d_vals` half of the custom-VJP backward
// `_spmm_vjp.bwd` of src/repro/kernels/ell_spmm.py (lines 80-92), which the
// TPU package leaves to XLA as a gather + einsum around the Pallas forward
// kernel `_ell_spmm_raw` (line 116).  The other half, d_h = A^T g, is
// csr_spmm.cu's write mode over the transposed pack.  No path of the port
// launches it today (the ELL values are constants of the graph); it
// completes the VJP.
//
// What bounds it on the H100: bytes.  Each slot reads the h row it names
// (d * 4 bytes) for 2 * d flops; the least traffic reads every slot's
// column and writes its value once, reads g once and each named h row
// once.  The stacked hybrid packs are 92-95% padding whose column is 0, so
// nearly all slots name one row.  The kernel:
//  - one warp per ELL row holds g[i] in registers, loaded once with
//    VEC-element vector loads (16 bytes where the row width and the base
//    addresses allow), and never reads it again;
//  - every slot whose column is 0 (the padding, and a live slot of column
//    0) gets <g[i], h[0]>, computed once per row and written to each such
//    slot by the lane that read its column: exact, and the same bits at
//    every such slot;
//  - the other slots are taken G = 32 / LPS at a time (LPS lanes a slot,
//    each lane NV vectors of the stripe), kUnroll (2) steps issuing their
//    h loads before their FMAs, as the forward kernel does; a slot's dot
//    is reduced over its LPS lanes in log2(LPS) shuffle steps, the G slots
//    of a step at once;
//  - a slot whose column lies outside [0, n_cols) gets 0;
//  - the feature columns are cut into stripes of LPS * NV * VEC columns,
//    the grid's y axis.  With one stripe the values are written straight
//    into d_vals; with several, each stripe writes its partial dots to a
//    scratch row and a second small kernel adds the stripes in order.
// Sums run in a fixed order: two launches give the same bits.
//
// The partition is the grid's z dimension, as in the forward kernel.  The
// host picks VEC, the stripe and LPS (kernels/ell_spmm.py:
// `dvals_launch_config`) and the C entry point maps them onto the template.

#include <cuda_runtime.h>
#include <stdint.h>

#include "on_device.cuh"
#include "words.cuh"

namespace {

constexpr int kWarps = 4;   // rows per block, one per warp
constexpr int kUnroll = 2;  // slot steps loaded before their FMAs
constexpr unsigned kFull = 0xffffffffu;

// the sum over the LPS lanes of this lane's slot group; every lane of the
// group gets the same bits (each butterfly step adds the same two values)
template <int LPS>
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int off = LPS / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// VEC: elements per load.  LPS: lanes per slot (8, 16 or 32).  NV: vectors
// per lane.  A warp's stripe is LPS * NV * VEC feature columns.  `out` is
// d_vals (one stripe) or the stripes' partial rows, stripe_stride apart.
template <int VEC, int LPS, int NV>
__global__ void __launch_bounds__(kWarps * 32)
ell_spmm_dvals_kernel(const int32_t* __restrict__ cols,
                      const float* __restrict__ g,
                      const float* __restrict__ h, float* __restrict__ out,
                      int n_rows, int k_slots, int n_cols, int d,
                      int64_t slot_stride, int64_t g_stride,
                      int64_t h_stride, int64_t stripe_stride) {
  using W = word_t<float, VEC>;
  constexpr int G = 32 / LPS;   // slots a warp takes at a time
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;    // warp-uniform
  const int64_t part = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int sub = lane / LPS;   // which of the G slots this lane serves
  const int sl = lane % LPS;

  const int64_t slot0 = part * slot_stride + static_cast<int64_t>(row) * k_slots;
  const int32_t* rc = cols + slot0;
  float* ro = out + blockIdx.y * stripe_stride + slot0;
  const float* hp = h + part * h_stride;
  const float* grow = g + part * g_stride + static_cast<int64_t>(row) * d;

  int fcol[NV];
  bool fok[NV];
  float gv[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    fcol[j] = blockIdx.y * (LPS * NV * VEC) + (sl + j * LPS) * VEC;
    fok[j] = fcol[j] < d;   // d % VEC == 0: a vector is all in or all out
    const W w = fok[j] ? __ldg(reinterpret_cast<const W*>(grow + fcol[j]))
                       : W{};
    const float* e = reinterpret_cast<const float*>(&w);
#pragma unroll
    for (int i = 0; i < VEC; ++i) gv[j][i] = e[i];
  }

  // this lane's share of <g[row], x> for the NV words x of one h row
  auto dot = [&](const W (&x)[NV]) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const float* e = reinterpret_cast<const float*>(&x[j]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) s = fmaf(gv[j][i], e[i], s);
    }
    return s;
  };

  // <g[row], h[0]>: the value of every slot of column 0 (0 without h rows)
  float zero_col;
  {
    W x[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j)
      x[j] = fok[j] && n_cols > 0
                 ? __ldg(reinterpret_cast<const W*>(hp + fcol[j]))
                 : W{};
    zero_col = group_sum<LPS>(dot(x));
  }

  for (int k0 = 0; k0 < k_slots; k0 += 32) {
    const int k = k0 + lane;
    const int c = k < k_slots ? __ldg(rc + k) : 0;
    const bool named = c > 0 && c < n_cols;
    if (k < k_slots && !named) ro[k] = c == 0 ? zero_col : 0.f;
    unsigned live = __ballot_sync(kFull, k < k_slots && named);
    while (live) {
      int ts[kUnroll];
      W x[kUnroll][NV];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // pop G slots (warp-uniform); this lane's group takes one
        int t = -1;
#pragma unroll
        for (int s = 0; s < G; ++s) {
          const int b = __ffs(live) - 1;   // -1 once none is left
          live &= live - 1;
          if (s == sub) t = b;
        }
        ts[u] = t;
        const int ct = __shfl_sync(kFull, c, t < 0 ? 0 : t);
        const float* hrow = hp + static_cast<int64_t>(ct) * d;
#pragma unroll
        for (int j = 0; j < NV; ++j)
          x[u][j] = t >= 0 && fok[j]
                        ? __ldg(reinterpret_cast<const W*>(hrow + fcol[j]))
                        : W{};
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float s = group_sum<LPS>(dot(x[u]));
        if (sl == 0 && ts[u] >= 0) ro[k0 + ts[u]] = s;
      }
    }
  }
}

// d_vals[i] = sum over the stripes, in order, of partial[s * n + i]
__global__ void __launch_bounds__(256)
sum_stripes_kernel(const float* __restrict__ partial,
                   float* __restrict__ dvals, int64_t n, int n_stripes) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * 256) {
    float s = 0.f;
    for (int st = 0; st < n_stripes; ++st) s += __ldg(partial + st * n + i);
    dvals[i] = s;
  }
}

struct Args {
  const void* cols;
  const void* g;
  const void* h;
  void* dvals;
  void* partial;
  int n_parts, n_rows, k_slots, n_cols, d;
  long long slot_stride, g_stride, h_stride;
  cudaStream_t stream;
};

template <int VEC, int LPS, int NV>
int launch(const Args& a) {
  constexpr int kStripe = LPS * NV * VEC;
  const int n_stripes = (a.d + kStripe - 1) / kStripe;
  const int64_t n = static_cast<int64_t>(a.n_parts) * a.slot_stride;
  if (n_stripes > 1 && a.partial == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  float* out = static_cast<float*>(n_stripes > 1 ? a.partial : a.dvals);
  const dim3 grid((a.n_rows + kWarps - 1) / kWarps, n_stripes, a.n_parts);
  ell_spmm_dvals_kernel<VEC, LPS, NV><<<grid, kWarps * 32, 0, a.stream>>>(
      static_cast<const int32_t*>(a.cols), static_cast<const float*>(a.g),
      static_cast<const float*>(a.h), out, a.n_rows, a.k_slots, a.n_cols,
      a.d, a.slot_stride, a.g_stride, a.h_stride, n);
  if (n_stripes > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t blocks = (n + 255) / 256;
    sum_stripes_kernel<<<static_cast<unsigned>(blocks < 65535 * 8 ? blocks
                                                               : 65535 * 8),
                         256, 0, a.stream>>>(
        out, static_cast<float*>(a.dvals), n, n_stripes);
  }
  return static_cast<int>(cudaGetLastError());
}

// stripe_vectors: vectors per warp row stripe, LPS * NV (NV <= 8)
template <int VEC>
int by_config(const Args& a, int stripe_vectors, int lanes_per_slot) {
  switch (stripe_vectors * 64 + lanes_per_slot) {
    case 16 * 64 + 8: return launch<VEC, 8, 2>(a);
    case 16 * 64 + 16: return launch<VEC, 16, 1>(a);
    case 32 * 64 + 8: return launch<VEC, 8, 4>(a);
    case 32 * 64 + 16: return launch<VEC, 16, 2>(a);
    case 32 * 64 + 32: return launch<VEC, 32, 1>(a);
    case 64 * 64 + 8: return launch<VEC, 8, 8>(a);
    case 64 * 64 + 16: return launch<VEC, 16, 4>(a);
    case 64 * 64 + 32: return launch<VEC, 32, 2>(a);
    case 128 * 64 + 16: return launch<VEC, 16, 8>(a);
    case 128 * 64 + 32: return launch<VEC, 32, 4>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// cols int32 [n_parts, n_rows, k_slots]; g f32 [n_parts, n_rows, d]; h f32
// [n_parts, n_cols, d]; dvals f32 [n_parts, n_rows, k_slots]; all
// contiguous, with the per-partition strides given in elements.  vec
// (elements per load: 1, 2 or 4) must divide d and keep g and h aligned;
// stripe_vectors in {16, 32, 64, 128} and lanes_per_slot in {8, 16, 32},
// with stripe_vectors / lanes_per_slot in [1, 8].  partial: f32 scratch of
// n_stripes * n_parts * n_rows * k_slots, where n_stripes = ceil(d /
// (stripe_vectors * vec)), or null when that is 1.  Launches on `device`
// and `stream`; returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a configuration it does not take.
extern "C" int ell_spmm_dvals_f32(const void* cols, const void* g,
                                  const void* h, void* dvals, void* partial,
                                  int n_parts, int n_rows, int k_slots,
                                  int n_cols, int d, long long slot_stride,
                                  long long g_stride, long long h_stride,
                                  int vec, int stripe_vectors,
                                  int lanes_per_slot, int device,
                                  void* stream) {
  const Args a{cols, g, h, dvals, partial, n_parts, n_rows, k_slots, n_cols,
               d, slot_stride, g_stride, h_stride,
               static_cast<cudaStream_t>(stream)};
  return on_device(device, [&] {
    switch (vec) {
      case 4: return by_config<4>(a, stripe_vectors, lanes_per_slot);
      case 2: return by_config<2>(a, stripe_vectors, lanes_per_slot);
      case 1: return by_config<1>(a, stripe_vectors, lanes_per_slot);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}
