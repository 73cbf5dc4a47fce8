// The per-edge values' cotangent of the edge-list aggregation, for Hopper
// (sm_90a), f32, all of GAT's heads in one launch.
//
// For out[:, z] = A(v[:, z]) h[:, z] over an edge list with H heads, A's
// entry k = (row(k), col[k]) being one live edge (kernels/ops.py:
// `edge_packs`), h [n_cols, H, d] and the output's cotangent g [n_rows, H,
// d] (rows of ld = H * d floats):
//
//   d_vals[perm[k], z] = <g[row(k), z, :], h[col[k], z, :]>
//
// for every entry k of A and head z, written through `perm` back to edge
// order (the wrapper zero-fills the edges A does not hold: the padding).
// This is GAT's attention gradient, the autodiff of the reference's
// `EdgeListAdj.spmm_at` per head (src/repro/models/gnn.py:103-105: `h[src]
// * e_vals[:, None]`, then `jax.ops.segment_sum`; the head loop at
// :284-286), a sampled dot product of g and h over the edge list.  It
// replaces no Pallas TPU kernel (the reference has none there); it
// completes the edge-list route's VJP in hand-written kernels, beside
// csr_spmm.cu's write mode over A (forward) and A^T (d_h).  H = 1 is the
// single-value form.
//
// What bounds it on the H100: bytes.  Each entry reads the h row it names
// (H * d * 4 bytes) for 2 * H * d flops; the least traffic reads each
// entry's col and perm once (8 bytes), each g row and each named h row
// once, and writes H values an entry.  Like csr_spmm.cu it reads one h
// row per entry, so its floor is the L2's rate over those rows.  Design:
//  - A's row list (kernels/ops.py: `csr_pack`, longest first over the
//    stack) is walked one warp per item: a short row, or a segment of at
//    most L entries of a long row (the in-degrees are power-law), which
//    finds its row by a binary search of long_seg_ptr;
//  - all heads in one pass where the row allows it (GAT's 4 heads of 64:
//    a row of 64 16-byte words): the warp holds its g row whole in
//    registers, reads 32 entries' (col, perm) once for all heads,
//    coalesced, and the next 32 while it works on these, and gathers each
//    entry's h row whole, 32 lanes across it, Q lanes a head; each
//    head's dot is summed over its own Q lanes by shuffles.  One launch
//    for the H heads, where one a head read the indices H times;
//  - otherwise head by head, as the single-head kernel: the warp holds
//    the head's g stripe in registers and gathers the entries' h stripes,
//    G = 32 / LPS entries at a time over LPS lanes (LPS the least power
//    of two that covers the head's vectors, at most 32), a head wider
//    than one stripe walked stripe by stripe, the lane adding each
//    stripe's dot into the value it wrote for the one before;
//  - NV vectors of VEC floats a lane (16-byte loads where the widths and
//    the base addresses allow); kUnroll (2) steps issue their loads
//    before their FMAs.  Each value belongs to one lane: no atomics,
//    every sum in a fixed order, two launches give the same bits.
// The host picks VEC, LPS, NV and Q (kernels/edge_spmm.py:
// `dvals_config`).

#include <cuda_runtime.h>
#include <stdint.h>

#include "on_device.cuh"
#include "words.cuh"

namespace {

constexpr int kWarps = 8;   // row-list items per block, one per warp
constexpr int kUnroll = 2;  // entry steps loaded before their FMAs
constexpr unsigned kFull = 0xffffffffu;

// the sum over the N lanes of this lane's aligned group of N; every lane
// of the group gets the same bits
template <int N>
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// One warp's row-list item: its row and entry range [lo, hi).
__device__ __forceinline__ void item_range(
    long long item, int n_seg, const int32_t* __restrict__ rowptr,
    const int32_t* __restrict__ short_rows, const int32_t* __restrict__ seg,
    const int32_t* __restrict__ long_rows,
    const int32_t* __restrict__ long_seg_ptr, int n_long, int& row, int& lo,
    int& hi) {
  if (item < n_seg) {
    const int s = static_cast<int>(item);
    lo = __ldg(seg + 2 * s);
    hi = __ldg(seg + 2 * s + 1);
    int a = 0, b = n_long;   // long_seg_ptr[a] <= s < long_seg_ptr[b]
    while (b - a > 1) {
      const int mid = (a + b) >> 1;
      if (__ldg(long_seg_ptr + mid) <= s) a = mid; else b = mid;
    }
    row = __ldg(long_rows + a);
  } else {
    row = __ldg(short_rows + static_cast<int>(item - n_seg));
    lo = __ldg(rowptr + row);
    hi = __ldg(rowptr + row + 1);
  }
}

// Q = 0, any shape: head by head, each head's row stripe by stripe, G =
// 32 / LPS entries a step over LPS lanes, each dot summed over its LPS
// lanes.  Q > 0 (the whole row in one stripe, ld = LPS * NV * VEC, and Q
// lanes a head): one pass over the entries for all the heads, lane sl's
// vector j belonging to head (sl + j * LPS) / Q, each head's dot summed
// over its Q lanes.
template <int VEC, int LPS, int NV, int Q>
__global__ void __launch_bounds__(kWarps * 32)
edge_dvals_kernel(const int32_t* __restrict__ rowptr,
                  const int32_t* __restrict__ col,
                  const int32_t* __restrict__ perm,
                  const int32_t* __restrict__ short_rows, int n_short,
                  const int32_t* __restrict__ seg, int n_seg,
                  const int32_t* __restrict__ long_rows,
                  const int32_t* __restrict__ long_seg_ptr, int n_long,
                  const float* __restrict__ g, const float* __restrict__ h,
                  float* __restrict__ dvals, int d, int heads) {
  using W = word_t<float, VEC>;
  constexpr int G = 32 / LPS;   // entries a warp takes at a time
  constexpr int kStripe = LPS * NV * VEC;
  const int lane = threadIdx.x & 31;
  const long long item =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= static_cast<long long>(n_seg) + n_short) return;  // warp-uniform
  int row, lo, hi;
  item_range(item, n_seg, rowptr, short_rows, seg, long_rows, long_seg_ptr,
             n_long, row, lo, hi);
  const int sub = lane / LPS;   // which of the G entries this lane serves
  const int sl = lane % LPS;
  const int64_t ld = static_cast<int64_t>(heads) * d;
  const float* grow = g + static_cast<int64_t>(row) * ld;

  if constexpr (Q > 0) {
    // the g row whole in registers, once an item
    float gv[NV][VEC];
    int hd[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int f = (sl + j * LPS) * VEC;
      hd[j] = (sl + j * LPS) / Q;
      const W w = __ldg(reinterpret_cast<const W*>(grow + f));
      const float* e = reinterpret_cast<const float*>(&w);
#pragma unroll
      for (int i = 0; i < VEC; ++i) gv[j][i] = e[i];
    }
    int c = 0, id = 0;
    if (lo < hi && lane < min(32, hi - lo)) {
      c = __ldg(col + lo + lane);
      id = __ldg(perm + lo + lane);
    }
    for (int k0 = lo; k0 < hi; k0 += 32) {
      const int n = min(32, hi - k0);
      // the next chunk's (col, perm), in flight while this one's rows load
      const int k1 = k0 + 32;
      int cn = 0, idn = 0;
      if (k1 < hi && lane < min(32, hi - k1)) {
        cn = __ldg(col + k1 + lane);
        idn = __ldg(perm + k1 + lane);
      }
      for (int t0 = 0; t0 < n; t0 += kUnroll * G) {
        int ts[kUnroll];
        W x[kUnroll][NV];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = t0 + u * G + sub;
          ts[u] = t;
          const int ct = __shfl_sync(kFull, c, t & 31);
          const float* hrow = h + static_cast<int64_t>(ct) * ld;
#pragma unroll
          for (int j = 0; j < NV; ++j)
            x[u][j] = t < n ? __ldg(reinterpret_cast<const W*>(
                                  hrow + (sl + j * LPS) * VEC))
                            : W{};
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int et = __shfl_sync(kFull, id, ts[u] & 31);
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            const float* e = reinterpret_cast<const float*>(&x[u][j]);
            float s = 0.f;
#pragma unroll
            for (int i = 0; i < VEC; ++i) s = fmaf(gv[j][i], e[i], s);
            s = group_sum<Q>(s);
            if (sl % Q == 0 && ts[u] < n)
              dvals[static_cast<int64_t>(et) * heads + hd[j]] = s;
          }
        }
      }
      c = cn;
      id = idn;
    }
    return;
  } else {
    for (int z = 0; z < heads; ++z) {   // warp-uniform
      const float* gz = grow + static_cast<int64_t>(z) * d;
      const float* hz = h + static_cast<int64_t>(z) * d;
      for (int f0 = 0; f0 < d; f0 += kStripe) {   // warp-uniform
        int fcol[NV];
        bool fok[NV];
        float gv[NV][VEC];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          fcol[j] = f0 + (sl + j * LPS) * VEC;
          fok[j] = fcol[j] < d;   // d % VEC == 0: a vector is all in or out
          const W w = fok[j] ? __ldg(reinterpret_cast<const W*>(gz + fcol[j]))
                             : W{};
          const float* e = reinterpret_cast<const float*>(&w);
#pragma unroll
          for (int i = 0; i < VEC; ++i) gv[j][i] = e[i];
        }
        for (int k0 = lo; k0 < hi; k0 += 32) {
          const int n = min(32, hi - k0);
          int c = 0, id = 0;
          if (lane < n) {
            c = __ldg(col + k0 + lane);
            id = __ldg(perm + k0 + lane);
          }
          for (int t0 = 0; t0 < n; t0 += kUnroll * G) {
            int ts[kUnroll];
            W x[kUnroll][NV];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const int t = t0 + u * G + sub;
              ts[u] = t;
              const int ct = __shfl_sync(kFull, c, t & 31);
              const float* hrow = hz + static_cast<int64_t>(ct) * ld;
#pragma unroll
              for (int j = 0; j < NV; ++j)
                x[u][j] = t < n && fok[j]
                              ? __ldg(reinterpret_cast<const W*>(hrow +
                                                                 fcol[j]))
                              : W{};
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              float s = 0.f;
#pragma unroll
              for (int j = 0; j < NV; ++j) {
                const float* e = reinterpret_cast<const float*>(&x[u][j]);
#pragma unroll
                for (int i = 0; i < VEC; ++i) s = fmaf(gv[j][i], e[i], s);
              }
              s = group_sum<LPS>(s);
              const int et = __shfl_sync(kFull, id, ts[u] & 31);
              if (sl == 0 && ts[u] < n) {
                float* o = dvals + static_cast<int64_t>(et) * heads + z;
                *o = f0 == 0 ? s : *o + s;
              }
            }
          }
        }
      }
    }
  }
}

struct Args {
  const void* rowptr;
  const void* col;
  const void* perm;
  const void* short_rows;
  int n_short;
  const void* seg;
  int n_seg;
  const void* long_rows;
  const void* long_seg_ptr;
  int n_long;
  const void* g;
  const void* h;
  void* dvals;
  int d;
  int heads;
  cudaStream_t stream;
};

template <int VEC, int LPS, int NV, int Q>
int launch(const Args& a) {
  const long long items = static_cast<long long>(a.n_seg) + a.n_short;
  const long long blocks = (items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL || a.heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    edge_dvals_kernel<VEC, LPS, NV, Q>
        <<<static_cast<unsigned>(blocks), kWarps * 32, 0, a.stream>>>(
            static_cast<const int32_t*>(a.rowptr),
            static_cast<const int32_t*>(a.col),
            static_cast<const int32_t*>(a.perm),
            static_cast<const int32_t*>(a.short_rows), a.n_short,
            static_cast<const int32_t*>(a.seg), a.n_seg,
            static_cast<const int32_t*>(a.long_rows),
            static_cast<const int32_t*>(a.long_seg_ptr), a.n_long,
            static_cast<const float*>(a.g), static_cast<const float*>(a.h),
            static_cast<float*>(a.dvals), a.d, a.heads);
  }
  return static_cast<int>(cudaGetLastError());
}

// lanes: entries' lanes (1 to 32, a power of two); nv: vectors a lane (1,
// 2 or 4, above 1 only with 32 lanes); q: lanes a head of the one-pass
// walk (4 to 32 with 16-byte words and 32 lanes), 0 for head by head
template <int VEC>
int by_lanes(const Args& a, int lanes, int nv, int q) {
  if constexpr (VEC == 4) {
    if (q) {
      if (lanes != 32) return static_cast<int>(cudaErrorInvalidValue);
      switch (nv * 64 + q) {
        case 1 * 64 + 4: return launch<4, 32, 1, 4>(a);
        case 1 * 64 + 8: return launch<4, 32, 1, 8>(a);
        case 1 * 64 + 16: return launch<4, 32, 1, 16>(a);
        case 1 * 64 + 32: return launch<4, 32, 1, 32>(a);
        case 2 * 64 + 4: return launch<4, 32, 2, 4>(a);
        case 2 * 64 + 8: return launch<4, 32, 2, 8>(a);
        case 2 * 64 + 16: return launch<4, 32, 2, 16>(a);
        case 2 * 64 + 32: return launch<4, 32, 2, 32>(a);
        case 4 * 64 + 4: return launch<4, 32, 4, 4>(a);
        case 4 * 64 + 8: return launch<4, 32, 4, 8>(a);
        case 4 * 64 + 16: return launch<4, 32, 4, 16>(a);
        case 4 * 64 + 32: return launch<4, 32, 4, 32>(a);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    }
  } else {
    if (q) return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (lanes * 8 + nv) {
    case 1 * 8 + 1: return launch<VEC, 1, 1, 0>(a);
    case 2 * 8 + 1: return launch<VEC, 2, 1, 0>(a);
    case 4 * 8 + 1: return launch<VEC, 4, 1, 0>(a);
    case 8 * 8 + 1: return launch<VEC, 8, 1, 0>(a);
    case 16 * 8 + 1: return launch<VEC, 16, 1, 0>(a);
    case 32 * 8 + 1: return launch<VEC, 32, 1, 0>(a);
    case 32 * 8 + 2: return launch<VEC, 32, 2, 0>(a);
    case 32 * 8 + 4: return launch<VEC, 32, 4, 0>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The forward pack's CSR (rowptr int32 [n_rows + 1], col and perm int32
// [nnz]) and row list (short_rows int32 [n_short]; seg int32 [n_seg, 2];
// long_rows int32 [n_long], long_seg_ptr int32 [n_long + 1]); g f32
// [n_rows, heads, d], h f32 [., heads, d]; dvals f32 [n_edges, heads] with
// every perm value in range; all contiguous.  vec (floats a load: 1, 2 or
// 4) must divide d and keep g and h aligned; q > 0 (lanes a head) walks
// all heads in one pass and needs heads * d == 32 * nv * vec.  Launches
// on `device` and `stream`; returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a configuration it does not take.
extern "C" int edge_dvals_f32(const void* rowptr, const void* col,
                              const void* perm, const void* short_rows,
                              int n_short, const void* seg, int n_seg,
                              const void* long_rows,
                              const void* long_seg_ptr, int n_long,
                              const void* g, const void* h, void* dvals,
                              int d, int heads, int vec, int lanes, int nv,
                              int q, int device, void* stream) {
  const Args a{rowptr, col, perm, short_rows, n_short, seg, n_seg,
               long_rows, long_seg_ptr, n_long, g, h, dvals, d, heads,
               static_cast<cudaStream_t>(stream)};
  return on_device(device, [&] {
    switch (vec) {
      case 4: return by_lanes<4>(a, lanes, nv, q);
      case 2: return by_lanes<2>(a, lanes, nv, q);
      case 1: return by_lanes<1>(a, lanes, nv, q);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}
