// GAT's edge softmax over an edge list's CSR packs, for Hopper (sm_90a),
// f32, all heads in one launch.
//
// For the forward pack A (kernels/ops.py: `edge_packs`; row r = p * n_rows
// + dst is one destination's live incoming edges, entry k's column col[k]
// = p * n_cols + src), per-node scores e_src and e_dst [P * n_cols, H]
// (rows of H floats) and node(r) = (r / n_rows) * n_cols + r % n_rows:
//
//   x[k, z]   = e_src[col[k], z] + e_dst[node(r), z]
//   logit     = leaky_relu(x, 0.2)
//   att[z, k] = exp(logit - max_row) / max(sum_row exp(logit - max_row), 1e-9)
//
// written in A's order as [H, nnz]: the per-head values of the CSR
// kernel's forward over A (csr_spmm.cu), so no gather puts them in order.
// The backward, given d_att (the `edge_dvals` kernel's output in A's
// order, [H, nnz]):
//
//   dx[k, z]       = att * (d_att - sum_row att * d_att) * (x > 0 ? 1 : 0.2)
//   d_e_dst[node(r), z] = sum over row r of dx
//                  = sum over row r of att * (d_att - sum_row ...) * (x > 0 ? 0 : -0.8)
//   d_e_src[c, z]  = sum over the entries whose column is c of dx
//
// (a row's att sums to 1, so the part of dx at slope 1 sums to 0 over the
// row: left out, it adds no rounding noise to d_e_dst, which is otherwise
// a sum that cancels, whole where every x of the row has one sign)
//
// the first two by a walk of A's rows (`edge_softmax_bwd_f32`, which
// writes dx entry-major, [nnz, H]), the last by a walk of the transposed
// pack A^T's rows (`edge_softmax_tr_f32`), whose entry j is A's entry
// amap[j]; that walk also writes att in A^T's order (att_t[z, j] =
// att[z, amap[j]]), the values of the CSR kernel's d_h over A^T.
//
// It replaces no Pallas TPU kernel: the reference computes the softmax with
// `jax.ops.segment_max`, `exp` and `segment_sum` and differentiates it with
// autodiff (src/repro/models/gnn.py:278-283), where the port's plain route
// was a scatter_reduce_ max, index_add_ sums and index_select gathers with
// atomic index_add_ backwards (models/gnn.py: `_edge_rows`,
// `_edge_softmax`).  A's rows are the softmax's segments, so a row's max
// and sums are one warp's registers and shuffles.
//
// What bounds it on the H100: bytes.  Per entry the forward reads col and
// one e_src row (H floats, a gather) and writes H values; the backward
// reads att and d_att and writes dx, then the transposed walk reads amap,
// dx's row (a gather) and att (a gather) and writes att_t.  Each is a few
// operations an entry.  Design:
//  - short rows (at most the pack's L entries, 256) one warp each, a lane
//    an entry, 32 entries at a time; a row's first KC entries a lane (KC *
//    32 >= L for up to 4 heads) keep their values in registers across the
//    passes, later ones are read again;
//  - long rows (more than L entries; the in- and out-degrees are
//    power-law, up to ~8.9k on the train cell) one block of kWarps warps
//    each, the whole row, its max and sums through shared memory in warp
//    order (the pack's segments of long rows are not used);
//  - every sum a lane's run in entry order, then the warp's xor butterfly
//    (commutative steps: every lane gets the same bits), then the block's
//    warps in order: no atomics, and two launches give the same bits;
//  - the heads of a row are one 16-byte load where H is a multiple of 4
//    and the base addresses allow (the host says so: `vec`); MH, the
//    heads a kernel is built for (1, 2, 4, 8, 16), bounds H, the rest
//    masked.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "on_device.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kBlock = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kSlope = 0.2f;   // leaky_relu's negative slope (GAT's 0.2)

// entries a lane keeps in registers: the forward's logits, the backward's
// att and d_att (with the signs of x as bits: KC * MH <= 32)
template <int MH> constexpr int kFwdCache = 32 / MH < 8 ? 32 / MH : 8;
template <int MH> constexpr int kBwdCache = 32 / MH < 4 ? 32 / MH : 4;

__device__ __forceinline__ float leaky(float x) {
  return x > 0.f ? x : kSlope * x;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The H floats of row i of p ([., heads]); z >= heads reads 0.
template <int MH>
__device__ __forceinline__ void load_heads(const float* __restrict__ p,
                                           int64_t i, int heads, bool vec,
                                           float (&v)[MH]) {
  const float* row = p + i * heads;
  if constexpr (MH % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int j = 0; j < MH / 4; ++j) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(row) + j);
        v[4 * j] = w.x;
        v[4 * j + 1] = w.y;
        v[4 * j + 2] = w.z;
        v[4 * j + 3] = w.w;
      }
      return;
    }
  }
#pragma unroll
  for (int z = 0; z < MH; ++z) v[z] = z < heads ? __ldg(row + z) : 0.f;
}

// x[k, :] = e_src[col[k], :] + ed
template <int MH>
__device__ __forceinline__ void entry_x(const int32_t* __restrict__ col,
                                        const float* __restrict__ e_src,
                                        int k, int heads, bool vec,
                                        const float (&ed)[MH],
                                        float (&x)[MH]) {
  load_heads<MH>(e_src, __ldg(col + k), heads, vec, x);
#pragma unroll
  for (int z = 0; z < MH; ++z) x[z] += ed[z];
}

// The block's max or sum of each lane's v[z], every thread getting the
// same bits: each warp's butterfly, then the warps in order.
template <int MH, bool kMax>
__device__ __forceinline__ void block_reduce(float (&v)[MH],
                                             float (*red)[MH]) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int z = 0; z < MH; ++z)
    v[z] = kMax ? warp_max(v[z]) : warp_sum(v[z]);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int z = 0; z < MH; ++z) red[warp][z] = v[z];
  }
  __syncthreads();
#pragma unroll
  for (int z = 0; z < MH; ++z) {
    float s = red[0][z];
    for (int w = 1; w < kWarps; ++w)
      s = kMax ? fmaxf(s, red[w][z]) : s + red[w][z];
    v[z] = s;
  }
  __syncthreads();   // red is reused by the next reduction
}

__device__ __forceinline__ int64_t node_of(int r, int n_rows, int n_cols) {
  return static_cast<int64_t>(r / n_rows) * n_cols + r % n_rows;
}

struct Fwd {
  const int32_t* rowptr;
  const int32_t* col;
  const int32_t* rows;   // short_rows, or long_rows
  int n_list;
  const float* e_src;
  const float* e_dst;
  float* att;
  int64_t nnz;
  int heads;
  int n_rows;
  int n_cols;
  bool vec;
};

// one warp a short row
template <int MH>
__global__ void __launch_bounds__(kBlock) softmax_fwd_short(const Fwd a) {
  constexpr int KC = kFwdCache<MH>;
  const int lane = threadIdx.x & 31;
  const int64_t item =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= a.n_list) return;   // warp-uniform
  const int r = __ldg(a.rows + item);
  const int lo = __ldg(a.rowptr + r), hi = __ldg(a.rowptr + r + 1);
  if (lo == hi) return;           // an empty row has no entry to write
  float ed[MH];
  load_heads<MH>(a.e_dst, node_of(r, a.n_rows, a.n_cols), a.heads, a.vec,
                 ed);
  float lg[KC][MH], m[MH];
#pragma unroll
  for (int z = 0; z < MH; ++z) m[z] = -INFINITY;
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    const int k = lo + lane + 32 * i;
    if (k < hi) {
      entry_x<MH>(a.col, a.e_src, k, a.heads, a.vec, ed, lg[i]);
#pragma unroll
      for (int z = 0; z < MH; ++z) {
        lg[i][z] = leaky(lg[i][z]);
        m[z] = fmaxf(m[z], lg[i][z]);
      }
    }
  }
  for (int k = lo + lane + 32 * KC; k < hi; k += 32) {
    float x[MH];
    entry_x<MH>(a.col, a.e_src, k, a.heads, a.vec, ed, x);
#pragma unroll
    for (int z = 0; z < MH; ++z) m[z] = fmaxf(m[z], leaky(x[z]));
  }
  float s[MH];
#pragma unroll
  for (int z = 0; z < MH; ++z) {
    m[z] = warp_max(m[z]);
    s[z] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    if (lo + lane + 32 * i < hi) {
#pragma unroll
      for (int z = 0; z < MH; ++z) s[z] += expf(lg[i][z] - m[z]);
    }
  }
  for (int k = lo + lane + 32 * KC; k < hi; k += 32) {
    float x[MH];
    entry_x<MH>(a.col, a.e_src, k, a.heads, a.vec, ed, x);
#pragma unroll
    for (int z = 0; z < MH; ++z) s[z] += expf(leaky(x[z]) - m[z]);
  }
#pragma unroll
  for (int z = 0; z < MH; ++z) s[z] = fmaxf(warp_sum(s[z]), 1e-9f);
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    const int k = lo + lane + 32 * i;
    if (k < hi) {
#pragma unroll
      for (int z = 0; z < MH; ++z)
        if (z < a.heads) a.att[z * a.nnz + k] = expf(lg[i][z] - m[z]) / s[z];
    }
  }
  for (int k = lo + lane + 32 * KC; k < hi; k += 32) {
    float x[MH];
    entry_x<MH>(a.col, a.e_src, k, a.heads, a.vec, ed, x);
#pragma unroll
    for (int z = 0; z < MH; ++z)
      if (z < a.heads)
        a.att[z * a.nnz + k] = expf(leaky(x[z]) - m[z]) / s[z];
  }
}

// one block a long row, the whole row
template <int MH>
__global__ void __launch_bounds__(kBlock) softmax_fwd_long(const Fwd a) {
  __shared__ float red[kWarps][MH];
  const int r = __ldg(a.rows + blockIdx.x);
  const int lo = __ldg(a.rowptr + r), hi = __ldg(a.rowptr + r + 1);
  float ed[MH], m[MH], s[MH], x[MH];
  load_heads<MH>(a.e_dst, node_of(r, a.n_rows, a.n_cols), a.heads, a.vec,
                 ed);
#pragma unroll
  for (int z = 0; z < MH; ++z) {
    m[z] = -INFINITY;
    s[z] = 0.f;
  }
  for (int k = lo + threadIdx.x; k < hi; k += kBlock) {
    entry_x<MH>(a.col, a.e_src, k, a.heads, a.vec, ed, x);
#pragma unroll
    for (int z = 0; z < MH; ++z) m[z] = fmaxf(m[z], leaky(x[z]));
  }
  block_reduce<MH, true>(m, red);
  for (int k = lo + threadIdx.x; k < hi; k += kBlock) {
    entry_x<MH>(a.col, a.e_src, k, a.heads, a.vec, ed, x);
#pragma unroll
    for (int z = 0; z < MH; ++z) s[z] += expf(leaky(x[z]) - m[z]);
  }
  block_reduce<MH, false>(s, red);
#pragma unroll
  for (int z = 0; z < MH; ++z) s[z] = fmaxf(s[z], 1e-9f);
  for (int k = lo + threadIdx.x; k < hi; k += kBlock) {
    entry_x<MH>(a.col, a.e_src, k, a.heads, a.vec, ed, x);
#pragma unroll
    for (int z = 0; z < MH; ++z)
      if (z < a.heads)
        a.att[z * a.nnz + k] = expf(leaky(x[z]) - m[z]) / s[z];
  }
}

struct Bwd {
  const int32_t* rowptr;
  const int32_t* col;
  const int32_t* rows;
  int n_list;
  const float* e_src;
  const float* e_dst;
  const float* att;     // [H, nnz], A's order
  const float* d_att;   // [H, nnz], A's order
  float* dx;            // [nnz, H]
  float* d_e_dst;       // [P * n_cols, H], zero where no row writes
  int64_t nnz;
  int heads;
  int n_rows;
  int n_cols;
  bool vec;
};

// att[., k] and d_att[., k] of entry k
template <int MH>
__device__ __forceinline__ void entry_att(const Bwd& a, int k, float (&at)[MH],
                                          float (&da)[MH]) {
#pragma unroll
  for (int z = 0; z < MH; ++z) {
    at[z] = z < a.heads ? __ldg(a.att + z * a.nnz + k) : 0.f;
    da[z] = z < a.heads ? __ldg(a.d_att + z * a.nnz + k) : 0.f;
  }
}

// dx of entry k from att, d_att, the row's dot and x's sign, written
// entry-major; its part at slope 1 less (the row's d_e_dst term) added
// into acc
template <int MH>
__device__ __forceinline__ void put_dx(const Bwd& a, int k, const float (&at)[MH],
                                       const float (&da)[MH],
                                       const float (&dot)[MH],
                                       const bool (&pos)[MH],
                                       float (&acc)[MH]) {
  float* o = a.dx + static_cast<int64_t>(k) * a.heads;
#pragma unroll
  for (int z = 0; z < MH; ++z) {
    const float u = at[z] * (da[z] - dot[z]);
    acc[z] += pos[z] ? 0.f : u * (kSlope - 1.f);
    if (z < a.heads) o[z] = pos[z] ? u : u * kSlope;
  }
}

// one warp a short row of A: dx and the row's d_e_dst
template <int MH>
__global__ void __launch_bounds__(kBlock) softmax_bwd_short(const Bwd a) {
  constexpr int KC = kBwdCache<MH>;
  const int lane = threadIdx.x & 31;
  const int64_t item =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= a.n_list) return;   // warp-uniform
  const int r = __ldg(a.rows + item);
  const int lo = __ldg(a.rowptr + r), hi = __ldg(a.rowptr + r + 1);
  if (lo == hi) return;           // d_e_dst stays 0
  const int64_t node = node_of(r, a.n_rows, a.n_cols);
  float ed[MH];
  load_heads<MH>(a.e_dst, node, a.heads, a.vec, ed);
  float at[KC][MH], da[KC][MH], dot[MH];
  unsigned pos_bits = 0;
#pragma unroll
  for (int z = 0; z < MH; ++z) dot[z] = 0.f;
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    const int k = lo + lane + 32 * i;
    if (k < hi) {
      float x[MH];
      entry_att<MH>(a, k, at[i], da[i]);
      entry_x<MH>(a.col, a.e_src, k, a.heads, a.vec, ed, x);
#pragma unroll
      for (int z = 0; z < MH; ++z) {
        dot[z] += at[i][z] * da[i][z];
        pos_bits |= static_cast<unsigned>(x[z] > 0.f) << (i * MH + z);
      }
    }
  }
  for (int k = lo + lane + 32 * KC; k < hi; k += 32) {
    float t[MH], d[MH];
    entry_att<MH>(a, k, t, d);
#pragma unroll
    for (int z = 0; z < MH; ++z) dot[z] += t[z] * d[z];
  }
  float acc[MH];
#pragma unroll
  for (int z = 0; z < MH; ++z) {
    dot[z] = warp_sum(dot[z]);
    acc[z] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    const int k = lo + lane + 32 * i;
    if (k < hi) {
      bool pos[MH];
#pragma unroll
      for (int z = 0; z < MH; ++z) pos[z] = (pos_bits >> (i * MH + z)) & 1u;
      put_dx<MH>(a, k, at[i], da[i], dot, pos, acc);
    }
  }
  for (int k = lo + lane + 32 * KC; k < hi; k += 32) {
    float t[MH], d[MH], x[MH];
    bool pos[MH];
    entry_att<MH>(a, k, t, d);
    entry_x<MH>(a.col, a.e_src, k, a.heads, a.vec, ed, x);
#pragma unroll
    for (int z = 0; z < MH; ++z) pos[z] = x[z] > 0.f;
    put_dx<MH>(a, k, t, d, dot, pos, acc);
  }
#pragma unroll
  for (int z = 0; z < MH; ++z) acc[z] = warp_sum(acc[z]);
  if (lane == 0) {
#pragma unroll
    for (int z = 0; z < MH; ++z)
      if (z < a.heads) a.d_e_dst[node * a.heads + z] = acc[z];
  }
}

// one block a long row of A
template <int MH>
__global__ void __launch_bounds__(kBlock) softmax_bwd_long(const Bwd a) {
  __shared__ float red[kWarps][MH];
  const int r = __ldg(a.rows + blockIdx.x);
  const int lo = __ldg(a.rowptr + r), hi = __ldg(a.rowptr + r + 1);
  const int64_t node = node_of(r, a.n_rows, a.n_cols);
  float ed[MH], dot[MH], acc[MH], t[MH], d[MH], x[MH];
  bool pos[MH];
  load_heads<MH>(a.e_dst, node, a.heads, a.vec, ed);
#pragma unroll
  for (int z = 0; z < MH; ++z) {
    dot[z] = 0.f;
    acc[z] = 0.f;
  }
  for (int k = lo + threadIdx.x; k < hi; k += kBlock) {
    entry_att<MH>(a, k, t, d);
#pragma unroll
    for (int z = 0; z < MH; ++z) dot[z] += t[z] * d[z];
  }
  block_reduce<MH, false>(dot, red);
  for (int k = lo + threadIdx.x; k < hi; k += kBlock) {
    entry_att<MH>(a, k, t, d);
    entry_x<MH>(a.col, a.e_src, k, a.heads, a.vec, ed, x);
#pragma unroll
    for (int z = 0; z < MH; ++z) pos[z] = x[z] > 0.f;
    put_dx<MH>(a, k, t, d, dot, pos, acc);
  }
  block_reduce<MH, false>(acc, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int z = 0; z < MH; ++z)
      if (z < a.heads) a.d_e_dst[node * a.heads + z] = acc[z];
  }
}

struct Tr {
  const int32_t* rowptr;   // A^T's
  const int32_t* rows;
  int n_list;
  const int32_t* amap;     // A^T entry -> A entry
  const float* dx;         // [nnz, H] in A's order, or null
  const float* att;        // [H, nnz] in A's order, or null
  float* d_e_src;          // [P * n_cols, H] (every row listed), or null
  float* att_t;            // [H, nnz] in A^T's order, or null
  int64_t nnz;
  int heads;
  bool vec;
};

// entry j of A^T: its dx row added into acc, att_t written
template <int MH>
__device__ __forceinline__ void tr_entry(const Tr& a, int j,
                                         float (&acc)[MH]) {
  const int e = __ldg(a.amap + j);
  if (a.dx != nullptr) {
    float v[MH];
    load_heads<MH>(a.dx, e, a.heads, a.vec, v);
#pragma unroll
    for (int z = 0; z < MH; ++z) acc[z] += v[z];
  }
  if (a.att_t != nullptr) {
#pragma unroll
    for (int z = 0; z < MH; ++z)
      if (z < a.heads) a.att_t[z * a.nnz + j] = __ldg(a.att + z * a.nnz + e);
  }
}

// one warp a short row of A^T: d_e_src of its column node, att_t
template <int MH>
__global__ void __launch_bounds__(kBlock) softmax_tr_short(const Tr a) {
  const int lane = threadIdx.x & 31;
  const int64_t item =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= a.n_list) return;   // warp-uniform
  const int c = __ldg(a.rows + item);
  const int lo = __ldg(a.rowptr + c), hi = __ldg(a.rowptr + c + 1);
  float acc[MH];
#pragma unroll
  for (int z = 0; z < MH; ++z) acc[z] = 0.f;
  for (int j = lo + lane; j < hi; j += 32) tr_entry<MH>(a, j, acc);
  if (a.d_e_src == nullptr) return;
#pragma unroll
  for (int z = 0; z < MH; ++z) acc[z] = warp_sum(acc[z]);
  if (lane == 0) {
#pragma unroll
    for (int z = 0; z < MH; ++z)
      if (z < a.heads) a.d_e_src[static_cast<int64_t>(c) * a.heads + z] = acc[z];
  }
}

// one block a long row of A^T
template <int MH>
__global__ void __launch_bounds__(kBlock) softmax_tr_long(const Tr a) {
  __shared__ float red[kWarps][MH];
  const int c = __ldg(a.rows + blockIdx.x);
  const int lo = __ldg(a.rowptr + c), hi = __ldg(a.rowptr + c + 1);
  float acc[MH];
#pragma unroll
  for (int z = 0; z < MH; ++z) acc[z] = 0.f;
  for (int j = lo + threadIdx.x; j < hi; j += kBlock) tr_entry<MH>(a, j, acc);
  if (a.d_e_src == nullptr) return;   // block-uniform
  block_reduce<MH, false>(acc, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int z = 0; z < MH; ++z)
      if (z < a.heads) a.d_e_src[static_cast<int64_t>(c) * a.heads + z] = acc[z];
  }
}

// short rows (n_short, a warp each) then long rows (n_long, a block each),
// both on `stream`; cudaGetLastError() after the launches
template <typename A, typename K1, typename K2>
int launch_pair(A a, K1 short_kernel, K2 long_kernel, const int32_t* short_rows,
                int n_short, const int32_t* long_rows, int n_long,
                cudaStream_t stream) {
  if (n_short > 0) {
    a.rows = short_rows;
    a.n_list = n_short;
    const unsigned blocks = (static_cast<unsigned>(n_short) + kWarps - 1) /
                            kWarps;
    short_kernel<<<blocks, kBlock, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_long > 0) {
    a.rows = long_rows;
    a.n_list = n_long;
    long_kernel<<<static_cast<unsigned>(n_long), kBlock, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// the kernel pair built for the least MH in (1, 2, 4, 8, 16) >= heads
#define BY_HEADS(SHORT, LONG)                                               \
  switch (heads <= 1 ? 1 : heads <= 2 ? 2 : heads <= 4 ? 4                  \
                                                : heads <= 8 ? 8 : 16) {    \
    case 1: return launch_pair(a, SHORT<1>, LONG<1>, S, n_short, L, n_long, \
                               st);                                         \
    case 2: return launch_pair(a, SHORT<2>, LONG<2>, S, n_short, L, n_long, \
                               st);                                         \
    case 4: return launch_pair(a, SHORT<4>, LONG<4>, S, n_short, L, n_long, \
                               st);                                         \
    case 8: return launch_pair(a, SHORT<8>, LONG<8>, S, n_short, L, n_long, \
                               st);                                         \
    default: return launch_pair(a, SHORT<16>, LONG<16>, S, n_short, L,      \
                                n_long, st);                                \
  }

bool bad_heads(int heads, int vec) {
  // vec: 16-byte loads of whole head rows, only where heads is the MH built
  return heads < 1 || heads > 16 ||
         (vec && !(heads == 4 || heads == 8 || heads == 16));
}

}  // namespace

// A's CSR (rowptr int32 [P * n_rows + 1], col int32 [nnz]) and row list
// (short_rows int32 [n_short], long_rows int32 [n_long]: every row of A with
// entries in one of them); e_src, e_dst f32 [P * n_cols, heads]; att f32
// [heads, nnz].  vec: e_src and e_dst 16-byte aligned, heads 4, 8 or 16.
// Launches on `device` and `stream`; returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for what it does not take.
extern "C" int edge_softmax_fwd_f32(const void* rowptr, const void* col,
                                    const void* short_rows, int n_short,
                                    const void* long_rows, int n_long,
                                    const void* e_src, const void* e_dst,
                                    void* att, long long nnz, int heads,
                                    int n_rows, int n_cols, int vec,
                                    int device, void* stream) {
  if (bad_heads(heads, vec) || n_rows < 1 || n_cols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Fwd a{static_cast<const int32_t*>(rowptr), static_cast<const int32_t*>(col),
        nullptr, 0, static_cast<const float*>(e_src),
        static_cast<const float*>(e_dst), static_cast<float*>(att), nnz,
        heads, n_rows, n_cols, vec != 0};
  const int32_t* S = static_cast<const int32_t*>(short_rows);
  const int32_t* L = static_cast<const int32_t*>(long_rows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    BY_HEADS(softmax_fwd_short, softmax_fwd_long)
  });
}

// A's CSR and row list as above; att and d_att f32 [heads, nnz] in A's
// order; dx f32 [nnz, heads]; d_e_dst f32 [P * n_cols, heads], zero-filled
// by the caller (rows of no entry keep it).  vec: e_src, e_dst 16-byte
// aligned, heads 4, 8 or 16.
extern "C" int edge_softmax_bwd_f32(const void* rowptr, const void* col,
                                    const void* short_rows, int n_short,
                                    const void* long_rows, int n_long,
                                    const void* e_src, const void* e_dst,
                                    const void* att, const void* d_att,
                                    void* dx, void* d_e_dst, long long nnz, int heads,
                                    int n_rows, int n_cols, int vec,
                                    int device, void* stream) {
  if (bad_heads(heads, vec) || n_rows < 1 || n_cols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Bwd a{static_cast<const int32_t*>(rowptr), static_cast<const int32_t*>(col),
        nullptr, 0, static_cast<const float*>(e_src),
        static_cast<const float*>(e_dst), static_cast<const float*>(att),
        static_cast<const float*>(d_att), static_cast<float*>(dx),
        static_cast<float*>(d_e_dst), nnz, heads, n_rows, n_cols, vec != 0};
  const int32_t* S = static_cast<const int32_t*>(short_rows);
  const int32_t* L = static_cast<const int32_t*>(long_rows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    BY_HEADS(softmax_bwd_short, softmax_bwd_long)
  });
}

// A^T's CSR (rowptr int32 [P * n_cols + 1]) and row list (every row, empty
// ones included, in short_rows or long_rows); amap int32 [nnz], each A^T
// entry's A entry.  With dx (f32 [nnz, heads]) writes d_e_src f32 [P *
// n_cols, heads]; with att (f32 [heads, nnz]) writes att_t f32 [heads,
// nnz]; either pair may be null.  vec: dx 16-byte aligned, heads 4, 8 or
// 16.
extern "C" int edge_softmax_tr_f32(const void* rowptr, const void* short_rows,
                                   int n_short, const void* long_rows,
                                   int n_long, const void* amap,
                                   const void* dx, const void* att,
                                   void* d_e_src, void* att_t, long long nnz,
                                   int heads, int vec, int device,
                                   void* stream) {
  if (bad_heads(heads, vec) || (dx == nullptr) != (d_e_src == nullptr) ||
      (att == nullptr) != (att_t == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Tr a{static_cast<const int32_t*>(rowptr), nullptr, 0,
       static_cast<const int32_t*>(amap), static_cast<const float*>(dx),
       static_cast<const float*>(att), static_cast<float*>(d_e_src),
       static_cast<float*>(att_t), nnz, heads, vec != 0};
  const int32_t* S = static_cast<const int32_t*>(short_rows);
  const int32_t* L = static_cast<const int32_t*>(long_rows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    BY_HEADS(softmax_tr_short, softmax_tr_long)
  });
}
