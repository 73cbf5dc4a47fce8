// Gather-side CSR SpMM for Hopper (sm_90a): f32 or bf16 x, f32 sums.
//
//   out[r, :] = (accumulate ? out[r, :] : 0) + sum_{e in row r} w[e] * x[col[e], :]
//
// for the rows of a row list (kernels/ops.py: `csr_pack`), over a CSR
// matrix whose rows and columns are the flattened partitions of the
// stacked layout, so one launch covers all P partitions.  Two uses:
//
//  - write mode, d_h = A^T g: the VJP of the ELL product
//    (`_spmm_vjp.bwd`, src/repro/kernels/ell_spmm.py:80-92, the backward of
//    the Pallas TPU kernel `_ell_spmm_raw` at line 116) and of the hybrid
//    product's COO tail (the autodiff of `h[tail_src]` and `segment_sum`,
//    src/repro/kernels/ops.py:73-76), together: the transposed CSR of the
//    whole hybrid adjacency, built once at stack time.  Its row list holds
//    every row of A^T, empty ones included, so every row of d_h is written
//    once: no zero fill, no atomics, and the same bits from run to run;
//  - accumulate mode, the hybrid product's tail forward (the segment sum
//    of src/repro/kernels/ops.py:68-77, which the note on TPU kernel #1
//    calls its second phase): the tail's CSR over its own rows, added into
//    the ELL kernel's output in stream order after it.
//
// What bounds it on the H100: bytes.  Each entry reads one x row (d * 4
// bytes in f32, d * 2 in bf16) for 2 * d flops, at most 0.5 flop per byte.
// The least it must move is the entries' col and w (8 bytes each), the
// row pointers, each x row an entry names once and each out row once (and
// once more in accumulate mode): on the training slice's A^T at d = 256,
// 11.0 + 0.8 + 100.2 + 201.4 MB, about 0.094 ms at 3.35 TB/s.  The kernel
// reads one x row per entry (as the ELL forward does) and lives on L2 hits.
// Design:
//  - the rows come in two classes, both listed on the host once per pack.
//    Short rows (at most L entries, L a constant of the pack): one warp
//    each, no shared memory and no barrier, ordered longest first so the
//    heaviest start first and a block's warps carry similar loads.  Long
//    rows (more than L; the transposed columns and tail rows are power-law,
//    up to 8,865 entries on the slices' packs): cut into segments of at
//    most L entries, one block of kWarps warps each, whose warps take
//    interleaved 32-entry chunks and sum their partial rows through shared
//    memory in warp order into one partial row per segment; a second small
//    kernel adds each long row's segment partials in segment order.  The
//    segments come first in the grid.  Every sum has a fixed order;
//  - the CSR holds no padding, so unlike the ELL kernel a warp needs no
//    ballot: it reads 32 entries' (col, w), one per lane, coalesced, and
//    hands them out with shuffles;
//  - x reads are VEC-element vector loads (16 bytes where the row width and
//    the base addresses allow, else 8, 4 or 2), LPS lanes per entry with NV
//    vectors each, and kUnroll (2) steps of entries load before their FMAs;
//  - 512-byte feature stripes on the grid's y axis, as in the ELL forward:
//    the blocks in flight share one stripe of x, which is what the L2 has
//    to hold.  The host picks VEC and the stripe (`ell_launch_config`);
//  - ragged feature edges are masked here; the caller makes no padded
//    copies.

#include <cuda_runtime.h>
#include <stdint.h>

#include "on_device.cuh"
#include "words.cuh"

namespace {

constexpr int kWarps = 8;   // short rows per block; warps per segment
constexpr int kUnroll = 2;  // entry steps loaded before their FMAs
constexpr int kReduceThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// acc += w[e] * x[col[e]] over the entries [begin, end) taken 32 at a time,
// chunks `step` apart.  This lane serves entries t % G == sub of a step
// and the feature columns fcol.
template <typename T, int VEC, int LPS, int NV>
__device__ __forceinline__ void walk(const int32_t* __restrict__ col,
                                     const float* __restrict__ w,
                                     const T* __restrict__ x, int d,
                                     int begin, int end, int step, int lane,
                                     const int (&fcol)[NV],
                                     const bool (&fok)[NV],
                                     float (&acc)[NV][VEC]) {
  constexpr int G = 32 / LPS;   // entries a warp takes at a time
  const int sub = lane / LPS;
  for (int k0 = begin; k0 < end; k0 += step) {
    const int n = min(32, end - k0);
    int c = 0;
    float v = 0.f;
    if (lane < n) {
      c = __ldg(col + k0 + lane);
      v = __ldg(w + k0 + lane);
    }
    for (int t0 = 0; t0 < n; t0 += kUnroll * G) {
      int cs[kUnroll];
      float vs[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * G + sub;
        ok[u] = t < n;
        cs[u] = __shfl_sync(kFull, c, t & 31);
        const float vt = __shfl_sync(kFull, v, t & 31);
        vs[u] = ok[u] ? vt : 0.f;
      }
      // all kUnroll steps' loads first, then their FMAs
      word_t<T, VEC> xs[kUnroll][NV];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* xrow = x + static_cast<int64_t>(cs[u]) * d;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          xs[u][j] = ok[u] && fok[j]
                         ? __ldg(reinterpret_cast<const word_t<T, VEC>*>(
                               xrow + fcol[j]))
                         : word_t<T, VEC>{};
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < NV; ++j) fma_word<T, VEC>(vs[u], xs[u][j], acc[j]);
    }
  }
  // the G groups hold partial sums of the same columns: add them up
#pragma unroll
  for (int off = LPS; off < 32; off <<= 1)
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[j][e] += __shfl_xor_sync(kFull, acc[j][e], off);
}

// T: the type of x and out.  VEC: elements per load.  LPS: lanes per entry
// (16 or 32).  NV: vectors per lane.  A warp's stripe is LPS * NV * VEC
// feature columns.  Blocks [0, n_seg) take one long-row segment each and
// write its partial row; the rest take kWarps short rows each.
template <typename T, int VEC, int LPS, int NV>
__global__ void __launch_bounds__(kWarps * 32)
csr_spmm_kernel(const int32_t* __restrict__ rowptr,
                const int32_t* __restrict__ col,
                const float* __restrict__ w,
                const int32_t* __restrict__ short_rows, int n_short,
                const int32_t* __restrict__ seg, int n_seg,
                const T* __restrict__ x, T* __restrict__ out,
                float* __restrict__ partial, int d, int accumulate) {
  constexpr int kStripe = LPS * NV * VEC;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sl = lane % LPS;
  const bool head = lane < LPS;   // holds the row's sums after `walk`

  int fcol[NV];
  bool fok[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    fcol[j] = blockIdx.y * kStripe + (sl + j * LPS) * VEC;
    fok[j] = fcol[j] < d;   // d % VEC == 0: a vector is all in or all out
  }
  float acc[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;

  if (static_cast<int>(blockIdx.x) < n_seg) {   // block-uniform
    __shared__ float part[kWarps][kStripe];
    const int s = blockIdx.x;
    const int lo = __ldg(seg + 2 * s), hi = __ldg(seg + 2 * s + 1);
    walk<T, VEC, LPS, NV>(col, w, x, d, lo + 32 * warp, hi, 32 * kWarps,
                          lane, fcol, fok, acc);
    if (head) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          part[warp][(sl + j * LPS) * VEC + e] = acc[j][e];
    }
    __syncthreads();
    if (warp != 0 || !head) return;
    float* prow = partial + static_cast<int64_t>(s) * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!fok[j]) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int i = (sl + j * LPS) * VEC + e;
        float sum = part[0][i];
#pragma unroll
        for (int k = 1; k < kWarps; ++k) sum += part[k][i];
        prow[fcol[j] + e] = sum;
      }
    }
    return;
  }

  const int i = (static_cast<int>(blockIdx.x) - n_seg) * kWarps + warp;
  if (i >= n_short) return;   // warp-uniform
  const int row = __ldg(short_rows + i);
  walk<T, VEC, LPS, NV>(col, w, x, d, __ldg(rowptr + row),
                        __ldg(rowptr + row + 1), 32, lane, fcol, fok, acc);
  if (!head) return;
  T* orow = out + static_cast<int64_t>(row) * d;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (!fok[j]) continue;
    if (accumulate) {
      // out + sum, as the plain version's (out + A x), one rounding
      float r[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) r[e] = acc[j][e];
      add_word<T, VEC>(orow + fcol[j], r);
      store_word<T, VEC>(orow + fcol[j], r);
    } else {
      store_word<T, VEC>(orow + fcol[j], acc[j]);
    }
  }
}

// out[long_rows[r]] = (accumulate ? out : 0) + the row's segment partials,
// added in segment order; one block per long row.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
csr_long_rows_kernel(const int32_t* __restrict__ long_rows,
                     const int32_t* __restrict__ long_seg_ptr,
                     const float* __restrict__ partial, T* __restrict__ out,
                     int d, int accumulate) {
  const int r = blockIdx.x;
  const int s0 = __ldg(long_seg_ptr + r), s1 = __ldg(long_seg_ptr + r + 1);
  T* orow = out + static_cast<int64_t>(__ldg(long_rows + r)) * d;
  for (int f = threadIdx.x; f < d; f += kReduceThreads) {
    float sum = 0.f;
    for (int s = s0; s < s1; ++s)
      sum += partial[static_cast<int64_t>(s) * d + f];
    if (accumulate) sum = to_f32(orow[f]) + sum;
    orow[f] = from_f32<T>(sum);
  }
}

struct Args {
  const void* rowptr;
  const void* col;
  const void* w;
  const void* short_rows;
  int n_short;
  const void* seg;
  int n_seg;
  const void* long_rows;
  const void* long_seg_ptr;
  int n_long;
  const void* x;
  void* out;
  void* partial;
  int d, accumulate;
  cudaStream_t stream;
};

template <typename T, int VEC, int LPS, int NV>
int launch(const Args& a) {
  constexpr int kStripe = LPS * NV * VEC;
  const long long blocks =
      a.n_seg + (static_cast<long long>(a.n_short) + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    const dim3 grid(static_cast<unsigned>(blocks),
                    (a.d + kStripe - 1) / kStripe);
    csr_spmm_kernel<T, VEC, LPS, NV><<<grid, kWarps * 32, 0, a.stream>>>(
        static_cast<const int32_t*>(a.rowptr),
        static_cast<const int32_t*>(a.col), static_cast<const float*>(a.w),
        static_cast<const int32_t*>(a.short_rows), a.n_short,
        static_cast<const int32_t*>(a.seg), a.n_seg,
        static_cast<const T*>(a.x), static_cast<T*>(a.out),
        static_cast<float*>(a.partial), a.d, a.accumulate);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.n_long > 0) {
    csr_long_rows_kernel<T><<<a.n_long, kReduceThreads, 0, a.stream>>>(
        static_cast<const int32_t*>(a.long_rows),
        static_cast<const int32_t*>(a.long_seg_ptr),
        static_cast<const float*>(a.partial), static_cast<T*>(a.out), a.d,
        a.accumulate);
  }
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

// The CSR (rowptr int32 [n_rows + 1], col int32 and w f32 [nnz]) and its
// row list: short_rows int32 [n_short]; seg int32 [n_seg, 2], each long-row
// segment's entry range [lo, hi); long_rows int32 [n_long] with
// long_seg_ptr int32 [n_long + 1], the segments of each.  x and out of one
// type (f32 or bf16), [., d] and [n_rows, d]; partial f32 [n_seg, d]
// scratch (null when n_seg is 0); all contiguous.  accumulate: 0 writes the
// listed rows, 1 adds into them.  vec (elements per load: 1, 2, 4, and 8
// for bf16) must divide d and keep x and out aligned; stripe_vectors in
// {16, 32, 64, 128}.  Launches on `device` and `stream` (a second, small
// kernel when n_long > 0); returns cudaGetLastError() after the launches,
// or cudaErrorInvalidValue for a configuration it does not take.
extern "C" int csr_spmm_f32(const void* rowptr, const void* col,
                            const void* w, const void* short_rows,
                            int n_short, const void* seg, int n_seg,
                            const void* long_rows, const void* long_seg_ptr,
                            int n_long, const void* x, void* out,
                            void* partial, int d, int accumulate, int vec,
                            int stripe_vectors, int device, void* stream) {
  const Args a{rowptr, col, w, short_rows, n_short, seg, n_seg,
               long_rows, long_seg_ptr, n_long, x, out, partial, d,
               accumulate, static_cast<cudaStream_t>(stream)};
  return on_device(device, [&] {
    switch (vec) {
      case 4: return by_stripe<float, 4>(a, stripe_vectors);
      case 2: return by_stripe<float, 2>(a, stripe_vectors);
      case 1: return by_stripe<float, 1>(a, stripe_vectors);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

extern "C" int csr_spmm_bf16(const void* rowptr, const void* col,
                             const void* w, const void* short_rows,
                             int n_short, const void* seg, int n_seg,
                             const void* long_rows, const void* long_seg_ptr,
                             int n_long, const void* x, void* out,
                             void* partial, int d, int accumulate, int vec,
                             int stripe_vectors, int device, void* stream) {
  const Args a{rowptr, col, w, short_rows, n_short, seg, n_seg,
               long_rows, long_seg_ptr, n_long, x, out, partial, d,
               accumulate, static_cast<cudaStream_t>(stream)};
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
