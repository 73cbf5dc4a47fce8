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
// the first two by a walk of A's rows, which writes dx and att together,
// entry-major ([nnz, 2H]: dx's H floats, then att's), the last by a walk
// of the transposed pack A^T's rows, whose entry j is A's entry amap[j]:
// one gather of 2H floats an entry (one 32-byte sector at 4 heads) gives
// its dx and its att, and that walk writes att in A^T's order (att_t[z,
// j] = att[z, amap[j]]), the values of the CSR kernel's d_h over A^T.
//
// It replaces no Pallas TPU kernel: the reference computes the softmax with
// `jax.ops.segment_max`, `exp` and `segment_sum` and differentiates it with
// autodiff (src/repro/models/gnn.py:278-283), where the port's plain route
// was a scatter_reduce_ max, index_add_ sums and index_select gathers with
// atomic index_add_ backwards (models/gnn.py: `_edge_rows`,
// `_edge_softmax`).
//
// What bounds it on the H100: not bytes (~33 MB forward, ~90 MB backward
// at the train cell, 0.010 / 0.027 ms) but latency: a row's chain of
// dependent loads (rows[item], its entry range, col, e_src), few entries a
// row (median 3 on A, 2 on A^T) and power-law long rows (up to 8,886
// entries).  Design:
//  - short rows (at most the pack's L entries, 256) in groups of g lanes
//    a row, g the least power of two >= its entries (1 to 32; a warp for
//    rows of 17-256), 32 / g rows a warp: the pack lists them longest
//    first, so rows of one g are runs of the list (CsrPack.runs: each
//    run's first row, first warp and log2 g); a warp finds its run with
//    one ballot over the table, and reads its row with the row's entry
//    range (CsrPack.short_span), not through rowptr.  A group's max and
//    sums are its lanes' runs in entry order, then an xor butterfly of
//    width g (commutative steps: every lane of the group gets the same
//    bits).  A lane's first KC entries keep their values in registers
//    across the passes, later ones are read again.  Empty rows take no
//    warp: att has no entry there, d_e_dst and d_e_src are zero-filled
//    by the caller;
//  - long rows (more than L entries) over the pack's segments (at most L
//    entries each), a warp a segment with U entries a lane in flight
//    (loaded before any is used), in two steps: the first writes each
//    segment's partial (the forward its logits into att and its (max,
//    sum), found in one online pass that rescales as it goes; the
//    backward its sum of att * d_att), the second, a launch of its own,
//    combines a row's partials in segment order (every warp of the row
//    gets the same bits) and finishes the segment: att, or dx and its
//    d_e_dst partial, which the walk of A^T sums per row.  The partials'
//    warps come first in the short rows' grid, so the short rows fill in
//    behind them and the second launch waits on little (a block a long
//    row measured slower: its longest row, 8,886 entries, set the whole
//    launch; PERF.md §6).  The walk of A^T's long rows (sums only)
//    takes a block a row, its threads strided over the row;
//  - no atomics: two launches give the same bits;
//  - the heads of a row are one 16-byte load where H is a multiple of 4
//    and the base addresses allow (the host says so: `vec`), the [nnz, 2H]
//    rows where H is even; MH, the heads a kernel is built for (1, 2, 4,
//    8, 16), bounds H, the rest masked;
//  - 256-thread blocks, at most 64 registers a thread up to 4 heads (4
//    blocks, 32 warps an SM).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "on_device.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kBlock = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kSlope = 0.2f;   // leaky_relu's negative slope (GAT's 0.2)
constexpr int kMaxLog2Lanes = 5;

// entries a lane keeps in registers: the forward's logits, the backward's
// att and d_att (with the signs of x as bits: KC * MH <= 32)
template <int MH> constexpr int kFwdCache = MH <= 8 ? 2 : 1;
template <int MH> constexpr int kBwdCache = MH <= 8 ? 4 : 2;
// entries a thread has in flight where it walks a row with a stride: the
// forward's long-row segments, the backward's past the cache, the
// transposed walk
template <int MH> constexpr int kFwdBatch = kFwdCache<MH>;
template <int MH> constexpr int kBwdBatch = kBwdCache<MH> / 2;
template <int MH> constexpr int kTrBatch = MH <= 4 ? 4 : 16 / MH;
// blocks an SM at up to 4 heads: 32 warps, <= 64 registers a thread; more
// heads hold more values a lane.  The forward's first launch keeps fewer
// values a lane and runs 48 warps an SM (<= 40 registers)
template <int MH> constexpr int kMinBlocks = MH <= 4 ? 4 : MH == 8 ? 2 : 1;
template <int MH> constexpr int kFwdMinBlocks = MH <= 4 ? 6 : kMinBlocks<MH>;

__device__ __forceinline__ float leaky(float x) {
  return x > 0.f ? x : kSlope * x;
}

// the max or sum over a group of g lanes (a power of two, aligned), every
// lane of the group getting the same bits; g is uniform over the warp
template <bool kMax>
__device__ __forceinline__ float group_reduce(float v, int g) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off < g) {
      const float o = __shfl_xor_sync(kFull, v, off);
      v = kMax ? fmaxf(v, o) : v + o;
    }
  }
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

// Entry e's row of the [nnz, 2H] buffer: dx's H floats, then att's.  In
// 16-byte words where heads == MH is even (the wrapper's allocation is
// 16-byte aligned).
template <int MH>
__device__ __forceinline__ void load_pair(const float* __restrict__ p,
                                          int64_t e, int heads,
                                          float (&dx)[MH], float (&at)[MH]) {
  const float* row = p + e * 2 * heads;
  if constexpr (MH % 2 == 0) {
    if (heads == MH) {
      float v[2 * MH];
#pragma unroll
      for (int j = 0; j < MH / 2; ++j) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(row) + j);
        v[4 * j] = w.x;
        v[4 * j + 1] = w.y;
        v[4 * j + 2] = w.z;
        v[4 * j + 3] = w.w;
      }
#pragma unroll
      for (int z = 0; z < MH; ++z) {
        dx[z] = v[z];
        at[z] = v[MH + z];
      }
      return;
    }
  }
#pragma unroll
  for (int z = 0; z < MH; ++z) {
    dx[z] = z < heads ? __ldg(row + z) : 0.f;
    at[z] = z < heads ? __ldg(row + heads + z) : 0.f;
  }
}

template <int MH>
__device__ __forceinline__ void store_pair(float* __restrict__ p, int64_t e,
                                           int heads, const float (&dx)[MH],
                                           const float (&at)[MH]) {
  float* row = p + e * 2 * heads;
  if constexpr (MH % 2 == 0) {
    if (heads == MH) {
      float v[2 * MH];
#pragma unroll
      for (int z = 0; z < MH; ++z) {
        v[z] = dx[z];
        v[MH + z] = at[z];
      }
#pragma unroll
      for (int j = 0; j < MH / 2; ++j)
        reinterpret_cast<float4*>(row)[j] =
            make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
      return;
    }
  }
#pragma unroll
  for (int z = 0; z < MH; ++z) {
    if (z < heads) {
      row[z] = dx[z];
      row[heads + z] = at[z];
    }
  }
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

__device__ __forceinline__ int64_t node_of(int r, int n_rows, int n_cols) {
  return static_cast<int64_t>(r / n_rows) * n_cols + r % n_rows;
}

// The row lists of one pack: the short rows, their entry ranges and runs,
// and the long rows with their segments.
struct Rows {
  const int32_t* rowptr;
  const int32_t* col;
  const int32_t* short_rows;
  const int32_t* short_span;   // [n_short][2]: each one's entry range
  const int32_t* runs;       // [n_runs + 1][3]: first row, first warp, log2 g
  int n_runs;
  int run_warps;
  const int32_t* seg;        // [n_seg][2]: entry range
  const int32_t* seg_long;   // [n_seg]: index into long_rows
  int n_seg;
  const int32_t* long_rows;
  const int32_t* long_seg_ptr;   // [n_long + 1], into seg
  int n_long;
};

// Short-row warp w's place: its group's row (or -1 where the group has
// none) and entry range [lo, hi) (empty without a row), the group's lanes
// g and this lane's index in it.
struct Slot {
  int row;
  int lo;
  int hi;
  int g;
  int sub;
};

__device__ __forceinline__ Slot find_slot(const Rows& p, int w, int lane) {
  // the last run whose first warp is <= w: first warps never decrease, so
  // the lanes that see one <= w are a prefix
  int run = 0;
  for (int base = 0; base < p.n_runs; base += 32) {
    const int i = base + lane;
    const bool le = i < p.n_runs && __ldg(p.runs + 3 * i + 1) <= w;
    const unsigned b = __ballot_sync(kFull, le);
    if (b) run = base + __popc(b) - 1;
    if (b != kFull) break;
  }
  const int first = __ldg(p.runs + 3 * run);
  const int w0 = __ldg(p.runs + 3 * run + 1);
  const int lg = min(__ldg(p.runs + 3 * run + 2), kMaxLog2Lanes);
  const int end = __ldg(p.runs + 3 * run + 3);
  const int item = first + ((w - w0) << (kMaxLog2Lanes - lg)) + (lane >> lg);
  Slot s;
  s.g = 1 << lg;
  s.sub = lane & (s.g - 1);
  s.row = -1;
  s.lo = s.hi = 0;
  if (item < end) {
    s.row = __ldg(p.short_rows + item);
    const int2 span = __ldg(reinterpret_cast<const int2*>(p.short_span) + item);
    s.lo = span.x;
    s.hi = span.y;
  }
  return s;
}

// The (max, sum) pair of an online softmax: m the max so far, s the sum of
// exp(v - m).  The merge is symmetric in its two pairs, so both lanes of a
// butterfly step get the same bits.
__device__ __forceinline__ void online_merge(float& m, float& s, float m2,
                                             float s2) {
  const float mx = fmaxf(m, m2);
  const float a = m == -INFINITY ? 0.f : s * expf(m - mx);
  const float b = m2 == -INFINITY ? 0.f : s2 * expf(m2 - mx);
  m = mx;
  s = a + b;
}

// The block's sum of each thread's v[z], every thread getting the same
// bits: each warp's butterfly, then the warps in order.
template <int MH>
__device__ __forceinline__ void block_sum(float (&v)[MH], float (*red)[MH]) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int z = 0; z < MH; ++z) v[z] = group_reduce<false>(v[z], 32);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int z = 0; z < MH; ++z) red[warp][z] = v[z];
  }
  __syncthreads();
#pragma unroll
  for (int z = 0; z < MH; ++z) {
    float s = red[0][z];
    for (int w = 1; w < kWarps; ++w) s += red[w][z];
    v[z] = s;
  }
}

struct Fwd {
  Rows a;
  const float* e_src;
  const float* e_dst;
  float* att;
  float* part;   // [n_seg][2][H]: each segment's (max, sum)
  int64_t nnz;
  int heads;
  int n_rows;
  int n_cols;
  bool vec;
};

// Long-row segment s of A, a warp: its logits into att and its (max, sum)
// into part, in one online pass (U entries a lane in flight, loaded before
// any is used) that rescales the sum as the max grows
template <int MH>
__device__ __forceinline__ void fwd_seg(const Fwd& f, int s, int lane) {
  constexpr int U = kFwdBatch<MH>;
  const int lo = __ldg(f.a.seg + 2 * s), hi = __ldg(f.a.seg + 2 * s + 1);
  const int r = __ldg(f.a.long_rows + __ldg(f.a.seg_long + s));
  float ed[MH], m[MH], sum[MH];
  load_heads<MH>(f.e_dst, node_of(r, f.n_rows, f.n_cols), f.heads, f.vec,
                 ed);
#pragma unroll
  for (int z = 0; z < MH; ++z) {
    m[z] = -INFINITY;
    sum[z] = 0.f;
  }
  for (int k0 = lo + lane; k0 < hi; k0 += 32 * U) {
    float x[U][MH];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k0 + 32 * u < hi)
        entry_x<MH>(f.a.col, f.e_src, k0 + 32 * u, f.heads, f.vec, ed, x[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + 32 * u;
      if (k >= hi) continue;
#pragma unroll
      for (int z = 0; z < MH; ++z) {
        const float l = leaky(x[u][z]);
        if (z < f.heads) f.att[z * f.nnz + k] = l;
        if (l > m[z]) {
          sum[z] = (m[z] == -INFINITY ? 0.f : sum[z] * expf(m[z] - l)) + 1.f;
          m[z] = l;
        } else {
          sum[z] += expf(l - m[z]);
        }
      }
    }
  }
#pragma unroll
  for (int z = 0; z < MH; ++z) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(kFull, m[z], off);
      const float s2 = __shfl_xor_sync(kFull, sum[z], off);
      online_merge(m[z], sum[z], m2, s2);
    }
  }
  if (lane == 0) {
    float* out = f.part + static_cast<int64_t>(s) * 2 * f.heads;
#pragma unroll
    for (int z = 0; z < MH; ++z) {
      if (z < f.heads) {
        out[z] = m[z];
        out[f.heads + z] = sum[z];
      }
    }
  }
}

// Long-row segment s of A, a warp, after every segment's partial: the
// row's (max, sum) from its segments' partials (in segment order within a
// lane, then the warp's butterfly: every warp of the row gets the same
// bits), then att of the segment's entries from their logits
template <int MH>
__global__ void __launch_bounds__(kBlock, kMinBlocks<MH>)
    softmax_fwd_long_f32(const Fwd f) {
  constexpr int U = kFwdBatch<MH>;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= f.a.n_seg) return;   // warp-uniform
  const int lo = __ldg(f.a.seg + 2 * s), hi = __ldg(f.a.seg + 2 * s + 1);
  const int i = __ldg(f.a.seg_long + s);
  const int s0 = __ldg(f.a.long_seg_ptr + i);
  const int s1 = __ldg(f.a.long_seg_ptr + i + 1);
  float m[MH], sum[MH];
#pragma unroll
  for (int z = 0; z < MH; ++z) {
    m[z] = -INFINITY;
    sum[z] = 0.f;
  }
  for (int t = s0 + lane; t < s1; t += 32) {
    const float* in = f.part + static_cast<int64_t>(t) * 2 * f.heads;
#pragma unroll
    for (int z = 0; z < MH; ++z)
      if (z < f.heads) online_merge(m[z], sum[z], in[z], in[f.heads + z]);
  }
#pragma unroll
  for (int z = 0; z < MH; ++z) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(kFull, m[z], off);
      const float s2 = __shfl_xor_sync(kFull, sum[z], off);
      online_merge(m[z], sum[z], m2, s2);
    }
    sum[z] = fmaxf(sum[z], 1e-9f);
  }
  for (int k0 = lo + lane; k0 < hi; k0 += 32 * U) {
    float l[U][MH];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int z = 0; z < MH; ++z)
        if (z < f.heads && k0 + 32 * u < hi)
          l[u][z] = f.att[z * f.nnz + k0 + 32 * u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int z = 0; z < MH; ++z)
        if (z < f.heads && k0 + 32 * u < hi)
          f.att[z * f.nnz + k0 + 32 * u] = expf(l[u][z] - m[z]) / sum[z];
    }
  }
}

// A short row in a group of g lanes: att of its entries
template <int MH>
__device__ __forceinline__ void fwd_short(const Fwd& f, const Slot& sl) {
  constexpr int KC = kFwdCache<MH>;
  const int g = sl.g, lo = sl.lo + sl.sub, hi = sl.hi;
  float ed[MH] = {};
  if (sl.row >= 0)
    load_heads<MH>(f.e_dst, node_of(sl.row, f.n_rows, f.n_cols), f.heads,
                   f.vec, ed);
  float lg[KC][MH], m[MH];
#pragma unroll
  for (int z = 0; z < MH; ++z) m[z] = -INFINITY;
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    const int k = lo + g * i;
    if (k < hi) {
      entry_x<MH>(f.a.col, f.e_src, k, f.heads, f.vec, ed, lg[i]);
#pragma unroll
      for (int z = 0; z < MH; ++z) {
        lg[i][z] = leaky(lg[i][z]);
        m[z] = fmaxf(m[z], lg[i][z]);
      }
    }
  }
  for (int k = lo + g * KC; k < hi; k += g) {
    float x[MH];
    entry_x<MH>(f.a.col, f.e_src, k, f.heads, f.vec, ed, x);
#pragma unroll
    for (int z = 0; z < MH; ++z) m[z] = fmaxf(m[z], leaky(x[z]));
  }
  float s[MH];
#pragma unroll
  for (int z = 0; z < MH; ++z) {
    m[z] = group_reduce<true>(m[z], g);
    s[z] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    if (lo + g * i < hi) {
#pragma unroll
      for (int z = 0; z < MH; ++z) s[z] += expf(lg[i][z] - m[z]);
    }
  }
  for (int k = lo + g * KC; k < hi; k += g) {
    float x[MH];
    entry_x<MH>(f.a.col, f.e_src, k, f.heads, f.vec, ed, x);
#pragma unroll
    for (int z = 0; z < MH; ++z) s[z] += expf(leaky(x[z]) - m[z]);
  }
#pragma unroll
  for (int z = 0; z < MH; ++z)
    s[z] = fmaxf(group_reduce<false>(s[z], g), 1e-9f);
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    const int k = lo + g * i;
    if (k < hi) {
#pragma unroll
      for (int z = 0; z < MH; ++z)
        if (z < f.heads) f.att[z * f.nnz + k] = expf(lg[i][z] - m[z]) / s[z];
    }
  }
  for (int k = lo + g * KC; k < hi; k += g) {
    float x[MH];
    entry_x<MH>(f.a.col, f.e_src, k, f.heads, f.vec, ed, x);
#pragma unroll
    for (int z = 0; z < MH; ++z)
      if (z < f.heads)
        f.att[z * f.nnz + k] = expf(leaky(x[z]) - m[z]) / s[z];
  }
}

// warps [0, n_seg): A's long-row segments' partials; then the short
// rows' warps
template <int MH>
__global__ void __launch_bounds__(kBlock, kFwdMinBlocks<MH>)
    softmax_fwd_f32(const Fwd f) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w < f.a.n_seg) {   // warp-uniform
    fwd_seg<MH>(f, w, lane);
    return;
  }
  if (w - f.a.n_seg >= f.a.run_warps) return;
  fwd_short<MH>(f, find_slot(f.a, w - f.a.n_seg, lane));
}

struct Bwd {
  Rows a;        // A
  Rows t;        // A^T
  const int32_t* amap;   // A^T entry -> A entry
  const float* e_src;
  const float* e_dst;
  const float* att;      // [H, nnz], A's order
  const float* d_att;    // [H, nnz], A's order, or null (att_t alone)
  float* dxatt;          // [nnz, 2H], A's order: dx, then att
  float* part;           // [n_seg of A][2][H]: row dot, d_e_dst partial
  float* d_e_src;        // [P * n_cols, H], zero-filled by the caller
  float* d_e_dst;        // [P * n_cols, H], zero-filled by the caller
  float* att_t;          // [H, nnz], A^T's order, or null
  int64_t nnz;
  int heads;
  int n_rows;
  int n_cols;
  bool vec;
};

// att[., k] and d_att[., k] of entry k
template <int MH>
__device__ __forceinline__ void entry_att(const Bwd& b, int k, float (&at)[MH],
                                          float (&da)[MH]) {
#pragma unroll
  for (int z = 0; z < MH; ++z) {
    at[z] = z < b.heads ? __ldg(b.att + z * b.nnz + k) : 0.f;
    da[z] = z < b.heads ? __ldg(b.d_att + z * b.nnz + k) : 0.f;
  }
}

// dx of entry k from att, d_att, the row's dot and x's sign, written with
// att into the [nnz, 2H] buffer; its part at slope 1 less (the row's
// d_e_dst term) added into acc
template <int MH>
__device__ __forceinline__ void put_dx(const Bwd& b, int k,
                                       const float (&at)[MH],
                                       const float (&da)[MH],
                                       const float (&dot)[MH],
                                       const bool (&pos)[MH],
                                       float (&acc)[MH]) {
  float dx[MH];
#pragma unroll
  for (int z = 0; z < MH; ++z) {
    const float u = at[z] * (da[z] - dot[z]);
    acc[z] += pos[z] ? 0.f : u * (kSlope - 1.f);
    dx[z] = pos[z] ? u : u * kSlope;
  }
  store_pair<MH>(b.dxatt, k, b.heads, dx, at);
}

// dx of the entries k = k0, k0 + step, ... below hi (put_dx), U of them
// loaded before any is written: all in flight at once
template <int MH>
__device__ __forceinline__ void bwd_entries(const Bwd& b, int k0, int hi,
                                            int step, const float (&ed)[MH],
                                            const float (&dot)[MH],
                                            float (&acc)[MH]) {
  constexpr int U = kBwdBatch<MH>;
  for (; k0 < hi; k0 += U * step) {
    float t[U][MH], d[U][MH], x[U][MH];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u * step < hi) {
        entry_att<MH>(b, k0 + u * step, t[u], d[u]);
        entry_x<MH>(b.a.col, b.e_src, k0 + u * step, b.heads, b.vec, ed,
                    x[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u * step < hi) {
        bool pos[MH];
#pragma unroll
        for (int z = 0; z < MH; ++z) pos[z] = x[u][z] > 0.f;
        put_dx<MH>(b, k0 + u * step, t[u], d[u], dot, pos, acc);
      }
    }
  }
}

// Long-row segment s of A, a warp: its sum of att * d_att into part
template <int MH>
__device__ __forceinline__ void bwd_seg(const Bwd& b, int s, int lane) {
  constexpr int U = kBwdCache<MH>;
  const int lo = __ldg(b.a.seg + 2 * s), hi = __ldg(b.a.seg + 2 * s + 1);
  float dot[MH];
#pragma unroll
  for (int z = 0; z < MH; ++z) dot[z] = 0.f;
  for (int k0 = lo + lane; k0 < hi; k0 += 32 * U) {
    float at[U][MH], da[U][MH];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k0 + 32 * u < hi) entry_att<MH>(b, k0 + 32 * u, at[u], da[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + 32 * u < hi) {
#pragma unroll
        for (int z = 0; z < MH; ++z) dot[z] += at[u][z] * da[u][z];
      }
    }
  }
#pragma unroll
  for (int z = 0; z < MH; ++z) dot[z] = group_reduce<false>(dot[z], 32);
  if (lane == 0) {
    float* out = b.part + static_cast<int64_t>(s) * 2 * b.heads;
#pragma unroll
    for (int z = 0; z < MH; ++z)
      if (z < b.heads) out[z] = dot[z];
  }
}

// the sum over A's long row i's segments of their partial `which` (0: the
// dot, 1: d_e_dst), in segment order within each lane, then the warp's
// butterfly
template <int MH>
__device__ __forceinline__ void row_sum(const Bwd& b, int i, int which,
                                        int lane, float (&v)[MH]) {
  const int s0 = __ldg(b.a.long_seg_ptr + i);
  const int s1 = __ldg(b.a.long_seg_ptr + i + 1);
#pragma unroll
  for (int z = 0; z < MH; ++z) v[z] = 0.f;
  for (int s = s0 + lane; s < s1; s += 32) {
    const float* in = b.part + (static_cast<int64_t>(s) * 2 + which) * b.heads;
#pragma unroll
    for (int z = 0; z < MH; ++z)
      if (z < b.heads) v[z] += in[z];
  }
#pragma unroll
  for (int z = 0; z < MH; ++z) v[z] = group_reduce<false>(v[z], 32);
}

// Long-row segment s of A, a warp, after every segment's dot: dx and att of
// its entries from the row's dot, and the segment's d_e_dst partial into
// part (the walk of A^T sums them per row)
template <int MH>
__global__ void __launch_bounds__(kBlock, kMinBlocks<MH>)
    softmax_bwd_long_f32(const Bwd b) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= b.a.n_seg) return;   // warp-uniform
  const int lo = __ldg(b.a.seg + 2 * s), hi = __ldg(b.a.seg + 2 * s + 1);
  const int i = __ldg(b.a.seg_long + s);
  float ed[MH], dot[MH], acc[MH];
  load_heads<MH>(b.e_dst, node_of(__ldg(b.a.long_rows + i), b.n_rows,
                                  b.n_cols), b.heads, b.vec, ed);
  row_sum<MH>(b, i, 0, lane, dot);
#pragma unroll
  for (int z = 0; z < MH; ++z) acc[z] = 0.f;
  bwd_entries<MH>(b, lo + lane, hi, 32, ed, dot, acc);
#pragma unroll
  for (int z = 0; z < MH; ++z) acc[z] = group_reduce<false>(acc[z], 32);
  if (lane == 0) {
    float* out = b.part + (static_cast<int64_t>(s) * 2 + 1) * b.heads;
#pragma unroll
    for (int z = 0; z < MH; ++z)
      if (z < b.heads) out[z] = acc[z];
  }
}

// A short row of A in a group of g lanes: dx and att of its entries, the
// row's d_e_dst
template <int MH>
__device__ __forceinline__ void bwd_short(const Bwd& b, const Slot& sl) {
  constexpr int KC = kBwdCache<MH>;
  const int g = sl.g, lo = sl.lo + sl.sub, hi = sl.hi;
  const int64_t node = node_of(max(sl.row, 0), b.n_rows, b.n_cols);
  float ed[MH] = {};
  if (sl.row >= 0) load_heads<MH>(b.e_dst, node, b.heads, b.vec, ed);
  float at[KC][MH], da[KC][MH], dot[MH];
  unsigned pos_bits = 0;
#pragma unroll
  for (int z = 0; z < MH; ++z) dot[z] = 0.f;
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    const int k = lo + g * i;
    if (k < hi) {
      float x[MH];
      entry_att<MH>(b, k, at[i], da[i]);
      entry_x<MH>(b.a.col, b.e_src, k, b.heads, b.vec, ed, x);
#pragma unroll
      for (int z = 0; z < MH; ++z) {
        dot[z] += at[i][z] * da[i][z];
        pos_bits |= static_cast<unsigned>(x[z] > 0.f) << (i * MH + z);
      }
    }
  }
  for (int k = lo + g * KC; k < hi; k += g) {
    float t[MH], d[MH];
    entry_att<MH>(b, k, t, d);
#pragma unroll
    for (int z = 0; z < MH; ++z) dot[z] += t[z] * d[z];
  }
  float acc[MH];
#pragma unroll
  for (int z = 0; z < MH; ++z) {
    dot[z] = group_reduce<false>(dot[z], g);
    acc[z] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    const int k = lo + g * i;
    if (k < hi) {
      bool pos[MH];
#pragma unroll
      for (int z = 0; z < MH; ++z) pos[z] = (pos_bits >> (i * MH + z)) & 1u;
      put_dx<MH>(b, k, at[i], da[i], dot, pos, acc);
    }
  }
  bwd_entries<MH>(b, lo + g * KC, hi, g, ed, dot, acc);
#pragma unroll
  for (int z = 0; z < MH; ++z) acc[z] = group_reduce<false>(acc[z], g);
  if (sl.row >= 0 && sl.sub == 0) {
#pragma unroll
    for (int z = 0; z < MH; ++z)
      if (z < b.heads) b.d_e_dst[node * b.heads + z] = acc[z];
  }
}

// warps [0, n_seg): A's long-row segments' dots; then A's short rows'
// warps
template <int MH>
__global__ void __launch_bounds__(kBlock, kMinBlocks<MH>)
    softmax_bwd_f32(const Bwd b) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w < b.a.n_seg) {   // warp-uniform
    bwd_seg<MH>(b, w, lane);
    return;
  }
  if (w - b.a.n_seg >= b.a.run_warps) return;
  bwd_short<MH>(b, find_slot(b.a, w - b.a.n_seg, lane));
}

// A^T's entries j = j0, j0 + step, ... below hi: each one's dx added into
// acc and its att written into att_t, kTrBatch of them in flight.  Reads
// the [nnz, 2H] buffer, or, without dx, att head-major.
template <int MH>
__device__ __forceinline__ void tr_walk(const Bwd& b, int j0, int hi,
                                        int step, float (&acc)[MH]) {
  constexpr int U = kTrBatch<MH>;
  for (int j = j0; j < hi; j += U * step) {
    int e[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      e[u] = j + u * step < hi ? __ldg(b.amap + j + u * step) : -1;
    float dx[U][MH], at[U][MH];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (e[u] < 0) continue;
      if (b.d_att != nullptr) {
        load_pair<MH>(b.dxatt, e[u], b.heads, dx[u], at[u]);
      } else {
#pragma unroll
        for (int z = 0; z < MH; ++z) {
          dx[u][z] = 0.f;
          at[u][z] = z < b.heads ? __ldg(b.att + z * b.nnz + e[u]) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (e[u] < 0) continue;
#pragma unroll
      for (int z = 0; z < MH; ++z) acc[z] += dx[u][z];
      if (b.att_t != nullptr) {
#pragma unroll
        for (int z = 0; z < MH; ++z)
          if (z < b.heads) b.att_t[z * b.nnz + j + u * step] = at[u][z];
      }
    }
  }
}

// blocks [0, A^T's n_long): A^T's long rows, a block each; then warps:
// A's long rows' d_e_dst (with dx), then A^T's short rows (d_e_src of
// their column node, att_t)
template <int MH>
__global__ void __launch_bounds__(kBlock, kMinBlocks<MH>)
    softmax_tr_f32(const Bwd b) {
  __shared__ float red[kWarps][MH];
  float acc[MH];
#pragma unroll
  for (int z = 0; z < MH; ++z) acc[z] = 0.f;
  if (static_cast<int>(blockIdx.x) < b.t.n_long) {   // block-uniform
    const int c = __ldg(b.t.long_rows + blockIdx.x);
    const int lo = __ldg(b.t.rowptr + c), hi = __ldg(b.t.rowptr + c + 1);
    tr_walk<MH>(b, lo + threadIdx.x, hi, kBlock, acc);
    if (b.d_att == nullptr) return;
    block_sum<MH>(acc, red);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int z = 0; z < MH; ++z)
        if (z < b.heads)
          b.d_e_src[static_cast<int64_t>(c) * b.heads + z] = acc[z];
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  int w = (blockIdx.x - b.t.n_long) * kWarps + (threadIdx.x >> 5);
  const int n_dst = b.d_att != nullptr ? b.a.n_long : 0;
  if (w < n_dst) {   // warp-uniform
    float v[MH];
    row_sum<MH>(b, w, 1, lane, v);
    const int64_t node =
        node_of(__ldg(b.a.long_rows + w), b.n_rows, b.n_cols);
    if (lane == 0) {
#pragma unroll
      for (int z = 0; z < MH; ++z)
        if (z < b.heads) b.d_e_dst[node * b.heads + z] = v[z];
    }
    return;
  }
  w -= n_dst;
  if (w >= b.t.run_warps) return;
  const Slot sl = find_slot(b.t, w, lane);
  tr_walk<MH>(b, sl.lo + sl.sub, sl.hi, sl.g, acc);
  if (b.d_att == nullptr) return;   // warp-uniform
#pragma unroll
  for (int z = 0; z < MH; ++z) acc[z] = group_reduce<false>(acc[z], sl.g);
  if (sl.row >= 0 && sl.sub == 0) {
#pragma unroll
    for (int z = 0; z < MH; ++z)
      if (z < b.heads)
        b.d_e_src[static_cast<int64_t>(sl.row) * b.heads + z] = acc[z];
  }
}

unsigned blocks_of(long long warps) {
  return static_cast<unsigned>((warps + kWarps - 1) / kWarps);
}

// The forward's launches on `stream`: the segments' partials and the short
// rows, then the segments' att
template <int MH>
int launch_fwd(const Fwd& f, cudaStream_t stream) {
  const long long warps = static_cast<long long>(f.a.n_seg) + f.a.run_warps;
  if (warps > 0)
    softmax_fwd_f32<MH><<<blocks_of(warps), kBlock, 0, stream>>>(f);
  if (f.a.n_seg > 0) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    softmax_fwd_long_f32<MH><<<blocks_of(f.a.n_seg), kBlock, 0, stream>>>(f);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward's launches on `stream`: with d_att, A's segments' dots and
// short rows, then A's segments' dx; then the walk of A^T
template <int MH>
int launch_bwd(const Bwd& b, cudaStream_t stream) {
  if (b.d_att != nullptr) {
    const long long warps = static_cast<long long>(b.a.n_seg) + b.a.run_warps;
    if (warps > 0) {
      softmax_bwd_f32<MH><<<blocks_of(warps), kBlock, 0, stream>>>(b);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (b.a.n_seg > 0) {
      softmax_bwd_long_f32<MH><<<blocks_of(b.a.n_seg), kBlock, 0, stream>>>(b);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  const long long warps =
      static_cast<long long>(b.d_att != nullptr ? b.a.n_long : 0) +
      b.t.run_warps;
  const long long blocks =
      b.t.n_long + static_cast<long long>(blocks_of(warps));
  if (blocks > 0)
    softmax_tr_f32<MH><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(b);
  return static_cast<int>(cudaGetLastError());
}

// the launches built for the least MH in (1, 2, 4, 8, 16) >= heads
#define BY_HEADS(LAUNCH, ARG)                                                \
  switch (heads <= 1 ? 1 : heads <= 2 ? 2 : heads <= 4 ? 4                   \
                                                : heads <= 8 ? 8 : 16) {     \
    case 1: return LAUNCH<1>(ARG, st);                                       \
    case 2: return LAUNCH<2>(ARG, st);                                       \
    case 4: return LAUNCH<4>(ARG, st);                                       \
    case 8: return LAUNCH<8>(ARG, st);                                       \
    default: return LAUNCH<16>(ARG, st);                                     \
  }

bool bad_heads(int heads, int vec) {
  // vec: 16-byte loads of whole head rows, only where heads is the MH built
  return heads < 1 || heads > 16 ||
         (vec && !(heads == 4 || heads == 8 || heads == 16));
}

Rows rows_of(const void* rowptr, const void* col, const void* short_rows,
             const void* short_span, const void* runs, int n_runs,
             int run_warps, const void* seg, const void* seg_long, int n_seg,
             const void* long_rows, const void* long_seg_ptr, int n_long) {
  return Rows{static_cast<const int32_t*>(rowptr),
              static_cast<const int32_t*>(col),
              static_cast<const int32_t*>(short_rows),
              static_cast<const int32_t*>(short_span),
              static_cast<const int32_t*>(runs), n_runs, run_warps,
              static_cast<const int32_t*>(seg),
              static_cast<const int32_t*>(seg_long), n_seg,
              static_cast<const int32_t*>(long_rows),
              static_cast<const int32_t*>(long_seg_ptr), n_long};
}

}  // namespace

// A's CSR (rowptr int32 [P * n_rows + 1], col int32 [nnz]) and row lists:
// short_rows int32 [n_short] with their entry ranges (short_span int32
// [n_short, 2]) and runs (int32 [n_runs + 1, 3], run_warps warps); the
// long rows' segments (seg int32 [n_seg, 2], seg_long int32 [n_seg]: each
// one's long row), long_rows int32 [n_long] and long_seg_ptr int32 [n_long
// + 1]; every row of A with entries in one of them.  e_src, e_dst f32 [P *
// n_cols, heads]; att f32 [heads, nnz]; part f32 [n_seg, 2, heads]
// (scratch).  vec: e_src and e_dst 16-byte aligned, heads 4, 8 or 16.
// Launches on `device` and `stream`; returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for what it does not take.
extern "C" int edge_softmax_fwd_f32(
    const void* rowptr, const void* col, const void* short_rows,
    const void* short_span, const void* runs, int n_runs, int run_warps,
    const void* seg, const void* seg_long, int n_seg, const void* long_rows,
    const void* long_seg_ptr, int n_long, const void* e_src,
    const void* e_dst, void* att, void* part, long long nnz, int heads,
    int n_rows, int n_cols, int vec, int device, void* stream) {
  if (bad_heads(heads, vec) || n_rows < 1 || n_cols < 1 || n_runs < 0 ||
      run_warps < 0 || n_seg < 0 || n_long < 0 ||
      (n_seg > 0 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Fwd f{rows_of(rowptr, col, short_rows, short_span, runs, n_runs,
                      run_warps, seg, seg_long, n_seg, long_rows,
                      long_seg_ptr, n_long),
              static_cast<const float*>(e_src),
              static_cast<const float*>(e_dst), static_cast<float*>(att),
              static_cast<float*>(part), nnz, heads, n_rows, n_cols,
              vec != 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int { BY_HEADS(launch_fwd, f) });
}

// A's CSR and row lists as above, then A^T's in the same form (t_...: P *
// n_cols rows, every row with entries listed) and amap int32 [nnz], each
// A^T entry's A entry.  att f32 [heads, nnz] in A's order.  With d_att
// (f32 [heads, nnz] in A's order) writes d_e_src and d_e_dst (f32 [P *
// n_cols, heads], zero-filled by the caller: rows of no entry keep it)
// through dxatt (f32 [nnz, 2 * heads], 16-byte aligned) and part (f32
// [n_seg, 2, heads], scratch); with att_t (f32 [heads, nnz]) writes att
// in A^T's order.  d_att, dxatt, d_e_src and d_e_dst are all given or all
// null; att_t may be null when they are given.  vec: e_src and e_dst
// 16-byte aligned, heads 4, 8 or 16.
extern "C" int edge_softmax_bwd_f32(
    const void* rowptr, const void* col, const void* short_rows,
    const void* short_span, const void* runs, int n_runs, int run_warps,
    const void* seg, const void* seg_long, int n_seg, const void* long_rows,
    const void* long_seg_ptr, int n_long, const void* t_rowptr,
    const void* t_col, const void* t_short_rows, const void* t_short_span,
    const void* t_runs, int t_n_runs, int t_run_warps, const void* t_seg,
    const void* t_seg_long, int t_n_seg, const void* t_long_rows,
    const void* t_long_seg_ptr, int t_n_long, const void* amap,
    const void* e_src, const void* e_dst, const void* att, const void* d_att,
    void* dxatt, void* part, void* d_e_src, void* d_e_dst, void* att_t,
    long long nnz, int heads, int n_rows, int n_cols, int vec, int device,
    void* stream) {
  const bool grads = d_att != nullptr;
  if (bad_heads(heads, vec) || n_rows < 1 || n_cols < 1 || n_runs < 0 ||
      t_n_runs < 0 || run_warps < 0 || t_run_warps < 0 || n_seg < 0 ||
      n_long < 0 || t_n_long < 0 || (dxatt != nullptr) != grads ||
      (d_e_src != nullptr) != grads || (d_e_dst != nullptr) != grads ||
      (grads && n_seg > 0 && part == nullptr) ||
      (!grads && att_t == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Bwd b{
      rows_of(rowptr, col, short_rows, short_span, runs, n_runs, run_warps,
              seg, seg_long, n_seg, long_rows, long_seg_ptr, n_long),
      rows_of(t_rowptr, t_col, t_short_rows, t_short_span, t_runs, t_n_runs,
              t_run_warps, t_seg, t_seg_long, t_n_seg, t_long_rows,
              t_long_seg_ptr, t_n_long),
      static_cast<const int32_t*>(amap), static_cast<const float*>(e_src),
      static_cast<const float*>(e_dst), static_cast<const float*>(att),
      static_cast<const float*>(d_att), static_cast<float*>(dxatt),
      static_cast<float*>(part), static_cast<float*>(d_e_src),
      static_cast<float*>(d_e_dst), static_cast<float*>(att_t), nnz, heads,
      n_rows, n_cols, vec != 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int { BY_HEADS(launch_bwd, b) });
}
