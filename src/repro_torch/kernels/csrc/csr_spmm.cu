// Gather-side CSR SpMM for Hopper (sm_90a): f32 or bf16 x, f32 sums.
//
//   out[r, :] = (accumulate ? out[r, :] : 0) + sum_{e in row r} w[e] * x[col[e], :]
//
// for the rows of a row list (kernels/ops.py: `csr_pack`), over a CSR
// matrix whose rows and columns are the flattened partitions of the
// stacked layout, so one launch covers all P partitions.  With H heads
// (GAT's attention), one launch computes H such products: head z has its
// own values (w + z * w_head_stride) and reads and writes columns
// [z * d, (z + 1) * d) of x and out rows of `ld` elements.  Its uses:
//
//  - write mode, d_h = A^T g: the VJP of the ELL product
//    (`_spmm_vjp.bwd`, src/repro/kernels/ell_spmm.py:80-92, the backward of
//    the Pallas TPU kernel `_ell_spmm_raw` at line 116) and of the hybrid
//    product's COO tail (the autodiff of `h[tail_src]` and `segment_sum`,
//    src/repro/kernels/ops.py:73-76), together: the transposed CSR of the
//    whole hybrid adjacency, built once at stack time.  Its row list holds
//    every row of A^T, empty ones included, so every row of d_h is written
//    once: no zero fill, no atomics, and the same bits from run to run.
//    The same mode serves the edge list's A and A^T (the `segment_sum`
//    backend, src/repro/models/gnn.py:99-105, GAT's heads in one launch),
//    the row gather's VJP and the 1.5D chunk;
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
// reads one x row stripe per entry, so it lives on L2 hits: its floor is
// the L2's rate over nnz x rows, not the device memory's over the bound's
// bytes (PERF.md: the same launch over an x that fits in the L2).
// Design:
//  - the rows come in two classes, both listed on the host once per pack.
//    Short rows (at most L entries, L a constant of the pack): one warp
//    each, no barrier.  Long rows (more than L; the transposed columns
//    and tail rows are power-law, up to 8,865 entries on the slices'
//    packs): cut into segments of at most L entries, one block of kWarps
//    warps each, whose warps take interleaved 32-entry chunks and sum
//    their partial rows through shared memory in warp order into one
//    partial row per segment; a second small kernel adds each long row's
//    segment partials in segment order.  The segments come first in the
//    grid.  Every sum has a fixed order;
//  - the feature stripes are the grid's y axis, and a transposed pack
//    lists its short rows partition by partition (ops.csr_pack's
//    `col_block`), longest first within one: the blocks in flight read
//    one partition's rows of the gradient, a slab the L2 holds (25 MB at
//    the train cell's 24k rows and d = 256).  A forward pack's partition
//    of x (50 MB) does not fit, and its rows go longest first over the
//    whole stack (PERF.md: each order measured on each route);
//  - the CSR holds no padding, so a warp needs no ballot: it reads 32
//    entries' (col, w), one per lane, coalesced, hands them out with
//    shuffles, and loads the next 32 while it reads this chunk's x rows;
//  - x reads are VEC-element vector loads (16 bytes where the row width and
//    the base addresses allow, else 8, 4 or 2), LPS lanes per entry with NV
//    vectors each.  How many entries' loads a warp keeps in flight is the
//    launch's mode: kRegs2 / kRegs4, two or four entry steps loaded into
//    registers before their FMAs, or kRing, a ring of stages in shared
//    memory filled by 16-byte `cp.async` copies (each lane's own slots,
//    so no barrier), the FMAs reading the stage that has landed while the
//    next seven entries' copies are in flight.  The host picks the mode,
//    VEC and the stripe (kernels/csr_spmm.py: `csr_launch_config`);
//  - ragged feature edges are masked here; the caller makes no padded
//    copies.

#include <cuda_runtime.h>
#include <stdint.h>

#include "on_device.cuh"
#include "words.cuh"

namespace {

constexpr int kWarps = 8;   // short rows per block; warps per segment
constexpr int kReduceThreads = 128;
constexpr int kRingBytes = 128;   // a lane's ring: 8 stages of 16 bytes
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kRegs2 = 0, kRegs4 = 1, kRing = 2 };

// The feature columns this lane serves and the head's offset, shared by
// every walk.
template <typename T, int VEC, int NV>
struct Lane {
  const int32_t* col;
  const float* w;
  const T* x;     // this head's first column
  int64_t ld;     // elements between x rows
  int fcol[NV];
  bool fok[NV];
};

// the entries of the chunk from k0 (a warp's chunks hold at most 32)
__device__ __forceinline__ int chunk_len(int k0, int end) {
  return min(32, end - k0);
}

// acc += w[e] * x[col[e]] over the entries [begin, end) taken 32 at a time,
// chunks `step` apart, DEPTH entry steps loaded into registers before
// their FMAs.  This lane serves entries t % G == sub of a step and the
// feature columns L.fcol.
template <typename T, int VEC, int LPS, int NV, int DEPTH>
__device__ __forceinline__ void walk_regs(const Lane<T, VEC, NV>& L,
                                          int begin, int end, int step,
                                          int lane, float (&acc)[NV][VEC]) {
  constexpr int G = 32 / LPS;   // entries a warp takes at a time
  const int sub = lane / LPS;
  int c = 0;
  float v = 0.f;
  if (begin < end && lane < chunk_len(begin, end)) {
    c = __ldg(L.col + begin + lane);
    v = __ldg(L.w + begin + lane);
  }
  for (int k0 = begin; k0 < end; k0 += step) {
    const int n = chunk_len(k0, end);
    // the next chunk's (col, w), in flight while this one's x rows load
    const int k1 = k0 + step;
    int cn = 0;
    float vn = 0.f;
    if (k1 < end && lane < chunk_len(k1, end)) {
      cn = __ldg(L.col + k1 + lane);
      vn = __ldg(L.w + k1 + lane);
    }
    for (int t0 = 0; t0 < n; t0 += DEPTH * G) {
      int cs[DEPTH];
      float vs[DEPTH];
      bool ok[DEPTH];
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {
        const int t = t0 + u * G + sub;
        ok[u] = t < n;
        cs[u] = __shfl_sync(kFull, c, t & 31);
        const float vt = __shfl_sync(kFull, v, t & 31);
        vs[u] = ok[u] ? vt : 0.f;
      }
      // all DEPTH steps' loads first, then their FMAs
      word_t<T, VEC> xs[DEPTH][NV];
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {
        const T* xrow = L.x + static_cast<int64_t>(cs[u]) * L.ld;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          xs[u][j] = ok[u] && L.fok[j]
                         ? __ldg(reinterpret_cast<const word_t<T, VEC>*>(
                               xrow + L.fcol[j]))
                         : word_t<T, VEC>{};
        }
      }
#pragma unroll
      for (int u = 0; u < DEPTH; ++u)
#pragma unroll
        for (int j = 0; j < NV; ++j)
          fma_word<T, VEC>(vs[u], xs[u][j], acc[j]);
    }
    c = cn;
    v = vn;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// walk_regs's sum with the x loads as a ring of STAGES entry steps in
// shared memory, filled by cp.async (16-byte words only).  Step s is
// entry t = (s % SPC) * G + sub of chunk s / SPC; the copies run STAGES -
// 1 steps ahead of the FMAs, at most one chunk ahead (STAGES - 1 < SPC),
// so two (col, w) registers a lane suffice: the copies' chunk and the
// FMAs'.  `ring` is this block's ring: slot (stage, j) of thread i at
// ring[(stage * NV + j) * blockDim + i], so a warp's slots are 512
// contiguous bytes.  Each lane reads only the slots it filled itself.
template <typename T, int VEC, int LPS, int NV>
__device__ __forceinline__ void walk_ring(const Lane<T, VEC, NV>& L,
                                          int begin, int end, int step,
                                          int lane, word_t<T, VEC>* ring,
                                          float (&acc)[NV][VEC]) {
  using W = word_t<T, VEC>;
  static_assert(sizeof(W) == 16, "the ring copies 16-byte words");
  constexpr int G = 32 / LPS;
  constexpr int SPC = 32 / G;                     // steps in a full chunk
  constexpr int STAGES = kRingBytes / (16 * NV);
  static_assert(STAGES >= 2 && STAGES - 1 < SPC, "ring depth");
  if (begin >= end) return;   // warp-uniform
  const int sub = lane / LPS;
  const int n_chunks = (end - begin + step - 1) / step;
  const int n_last = chunk_len(begin + (n_chunks - 1) * step, end);
  const int total = (n_chunks - 1) * SPC + (n_last + G - 1) / G;
  const int nt = blockDim.x;
  W* mine = ring + threadIdx.x;

  int ci = 0, ji = -1;       // the copies' chunk: its cols
  float vq = 0.f;            // ... and its weights, for the FMAs later
  int jc = -1;
  float vc = 0.f;            // the FMAs' chunk's weights
  auto issue = [&](int s) {
    const int j = s / SPC;
    const int k0 = begin + j * step;
    if (j != ji) {   // warp-uniform
      ji = j;
      ci = 0;
      vq = 0.f;
      if (lane < chunk_len(k0, end)) {
        ci = __ldg(L.col + k0 + lane);
        vq = __ldg(L.w + k0 + lane);
      }
    }
    const int t = (s % SPC) * G + sub;
    const bool ok = t < chunk_len(k0, end);
    const int c = __shfl_sync(kFull, ci, t & 31);
    const T* xrow = L.x + static_cast<int64_t>(c) * L.ld;
    W* slot = mine + static_cast<int64_t>(s % STAGES) * NV * nt;
#pragma unroll
    for (int jv = 0; jv < NV; ++jv) {
      const bool live = ok && L.fok[jv];
      cp_async16(slot + jv * nt, live ? xrow + L.fcol[jv] : L.x,
                 live ? 16 : 0);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) issue(s); else cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    // vq holds chunk s / SPC's weights until the copies pass into the
    // chunk after it, which happens only after this step's FMAs
    if (s / SPC != jc) {
      jc = s / SPC;
      vc = vq;
    }
    const int t = (s % SPC) * G + sub;
    const float v = __shfl_sync(kFull, vc, t & 31);
    if (s + STAGES - 1 < total) issue(s + STAGES - 1); else cp_async_commit();
    cp_async_wait<STAGES - 1>();   // step s has landed
    const W* slot = mine + static_cast<int64_t>(s % STAGES) * NV * nt;
#pragma unroll
    for (int jv = 0; jv < NV; ++jv) {
      const W xw = slot[jv * nt];
      fma_word<T, VEC>(v, xw, acc[jv]);
    }
  }
  cp_async_wait<0>();
}

// the G groups of a warp hold partial sums of the same columns: add them
template <int LPS, int NV, int VEC>
__device__ __forceinline__ void reduce_groups(float (&acc)[NV][VEC]) {
#pragma unroll
  for (int off = LPS; off < 32; off <<= 1)
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[j][e] += __shfl_xor_sync(kFull, acc[j][e], off);
}

template <typename T, int VEC, int LPS, int NV, int MODE>
__device__ __forceinline__ void walk(const Lane<T, VEC, NV>& L, int begin,
                                     int end, int step, int lane,
                                     unsigned char* smem,
                                     float (&acc)[NV][VEC]) {
  if constexpr (MODE == kRing) {
    walk_ring<T, VEC, LPS, NV>(L, begin, end, step, lane,
                               reinterpret_cast<word_t<T, VEC>*>(smem), acc);
  } else {
    walk_regs<T, VEC, LPS, NV, MODE == kRegs4 ? 4 : 2>(L, begin, end, step,
                                                       lane, acc);
  }
  reduce_groups<LPS, NV, VEC>(acc);
}

// a block's shared memory: the segments' partial rows, or the ring
template <int VEC, int LPS, int NV, int MODE>
struct SmemBytes {
  static constexpr int part = kWarps * LPS * NV * VEC * 4;
  static constexpr int ring = MODE == kRing ? kWarps * 32 * kRingBytes : 0;
  static constexpr int value = part > ring ? part : ring;
};

// T: the type of x and out.  VEC: elements per load.  LPS: lanes per entry
// (16 or 32).  NV: vectors per lane.  MODE: how the x loads are kept in
// flight.  A warp's stripe is LPS * NV * VEC feature columns.  Blocks
// [0, n_seg) take one long-row segment each and write its partial row; the
// rest take kWarps short rows each.  blockIdx.z is the head.
template <typename T, int VEC, int LPS, int NV, int MODE>
__global__ void __launch_bounds__(kWarps * 32)
csr_spmm_kernel(const int32_t* __restrict__ rowptr,
                const int32_t* __restrict__ col,
                const float* __restrict__ w, int64_t w_head_stride,
                const int32_t* __restrict__ short_rows, int n_short,
                const int32_t* __restrict__ seg, int n_seg,
                const T* __restrict__ x, T* __restrict__ out,
                float* __restrict__ partial, int d, int64_t ld,
                int accumulate) {
  constexpr int kStripe = LPS * NV * VEC;
  __shared__ __align__(16) unsigned char
      smem[SmemBytes<VEC, LPS, NV, MODE>::value];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sl = lane % LPS;
  const bool head = lane < LPS;   // holds the row's sums after `walk`
  const int z = blockIdx.z;

  Lane<T, VEC, NV> L;
  L.col = col;
  L.w = w + z * w_head_stride;
  L.x = x + static_cast<int64_t>(z) * d;
  L.ld = ld;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    L.fcol[j] = blockIdx.y * kStripe + (sl + j * LPS) * VEC;
    L.fok[j] = L.fcol[j] < d;   // d % VEC == 0: a vector is all in or out
  }
  float acc[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;

  if (static_cast<int>(blockIdx.x) < n_seg) {   // block-uniform
    const int s = blockIdx.x;
    const int lo = __ldg(seg + 2 * s), hi = __ldg(seg + 2 * s + 1);
    walk<T, VEC, LPS, NV, MODE>(L, lo + 32 * warp, hi, 32 * kWarps, lane,
                                smem, acc);
    __syncthreads();   // the ring's slots become the partials
    float (*part)[kStripe] = reinterpret_cast<float (*)[kStripe]>(smem);
    if (head) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          part[warp][(sl + j * LPS) * VEC + e] = acc[j][e];
    }
    __syncthreads();
    if (warp != 0 || !head) return;
    float* prow = partial + (static_cast<int64_t>(z) * n_seg + s) * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!L.fok[j]) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int i = (sl + j * LPS) * VEC + e;
        float sum = part[0][i];
#pragma unroll
        for (int k = 1; k < kWarps; ++k) sum += part[k][i];
        prow[L.fcol[j] + e] = sum;
      }
    }
    return;
  }

  const int i = (static_cast<int>(blockIdx.x) - n_seg) * kWarps + warp;
  if (i >= n_short) return;   // warp-uniform
  const int row = __ldg(short_rows + i);
  walk<T, VEC, LPS, NV, MODE>(L, __ldg(rowptr + row), __ldg(rowptr + row + 1),
                              32, lane, smem, acc);
  if (!head) return;
  T* orow = out + static_cast<int64_t>(row) * ld + static_cast<int64_t>(z) * d;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (!L.fok[j]) continue;
    if (accumulate) {
      // out + sum, as the plain version's (out + A x), one rounding
      float r[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) r[e] = acc[j][e];
      add_word<T, VEC>(orow + L.fcol[j], r);
      store_word<T, VEC>(orow + L.fcol[j], r);
    } else {
      store_word<T, VEC>(orow + L.fcol[j], acc[j]);
    }
  }
}

// out[long_rows[r]] = (accumulate ? out : 0) + the row's segment partials,
// added in segment order; one block per long row and head.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
csr_long_rows_kernel(const int32_t* __restrict__ long_rows,
                     const int32_t* __restrict__ long_seg_ptr,
                     const float* __restrict__ partial, int n_seg,
                     T* __restrict__ out, int d, int64_t ld,
                     int accumulate) {
  const int r = blockIdx.x;
  const int z = blockIdx.y;
  const int s0 = __ldg(long_seg_ptr + r), s1 = __ldg(long_seg_ptr + r + 1);
  T* orow = out + static_cast<int64_t>(__ldg(long_rows + r)) * ld +
            static_cast<int64_t>(z) * d;
  const float* pz = partial + static_cast<int64_t>(z) * n_seg * d;
  for (int f = threadIdx.x; f < d; f += kReduceThreads) {
    float sum = 0.f;
    for (int s = s0; s < s1; ++s) sum += pz[static_cast<int64_t>(s) * d + f];
    if (accumulate) sum = to_f32(orow[f]) + sum;
    orow[f] = from_f32<T>(sum);
  }
}

struct Args {
  const void* rowptr;
  const void* col;
  const void* w;
  long long w_head_stride;
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
  int d;
  long long ld;
  int heads;
  int accumulate;
  cudaStream_t stream;
};

template <typename T, int VEC, int LPS, int NV, int MODE>
int launch(const Args& a) {
  constexpr int kStripe = LPS * NV * VEC;
  const long long blocks =
      a.n_seg + (static_cast<long long>(a.n_short) + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL || a.heads < 1 || a.heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    const dim3 grid(static_cast<unsigned>(blocks),
                    (a.d + kStripe - 1) / kStripe, a.heads);
    csr_spmm_kernel<T, VEC, LPS, NV, MODE><<<grid, kWarps * 32, 0,
                                             a.stream>>>(
        static_cast<const int32_t*>(a.rowptr),
        static_cast<const int32_t*>(a.col), static_cast<const float*>(a.w),
        a.w_head_stride, static_cast<const int32_t*>(a.short_rows),
        a.n_short, static_cast<const int32_t*>(a.seg), a.n_seg,
        static_cast<const T*>(a.x), static_cast<T*>(a.out),
        static_cast<float*>(a.partial), a.d, a.ld, a.accumulate);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.n_long > 0) {
    csr_long_rows_kernel<T><<<dim3(a.n_long, a.heads), kReduceThreads, 0,
                              a.stream>>>(
        static_cast<const int32_t*>(a.long_rows),
        static_cast<const int32_t*>(a.long_seg_ptr),
        static_cast<const float*>(a.partial), a.n_seg,
        static_cast<T*>(a.out), a.d, a.ld, a.accumulate);
  }
  return static_cast<int>(cudaGetLastError());
}

// stripe_vectors: vectors per warp row stripe, LPS * NV
template <typename T, int VEC, int MODE>
int by_stripe(const Args& a, int stripe_vectors) {
  switch (stripe_vectors) {
    case 16: return launch<T, VEC, 16, 1, MODE>(a);
    case 32: return launch<T, VEC, 32, 1, MODE>(a);
    case 64: return launch<T, VEC, 32, 2, MODE>(a);
    case 128: return launch<T, VEC, 32, 4, MODE>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// kRegs4 and kRing are built for 16-byte words only; narrower words take
// kRegs2
template <typename T, int VEC>
int by_mode(const Args& a, int stripe_vectors, int mode) {
  if constexpr (VEC * sizeof(T) == 16) {
    switch (mode) {
      case kRegs2: return by_stripe<T, VEC, kRegs2>(a, stripe_vectors);
      case kRegs4: return by_stripe<T, VEC, kRegs4>(a, stripe_vectors);
      case kRing: return by_stripe<T, VEC, kRing>(a, stripe_vectors);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    if (mode != kRegs2) return static_cast<int>(cudaErrorInvalidValue);
    return by_stripe<T, VEC, kRegs2>(a, stripe_vectors);
  }
}

}  // namespace

// The CSR (rowptr int32 [n_rows + 1], col int32 [nnz]) with `heads` value
// arrays (w f32, head z's at w + z * w_head_stride) and its row list:
// short_rows int32 [n_short]; seg int32 [n_seg, 2], each long-row
// segment's entry range [lo, hi); long_rows int32 [n_long] with
// long_seg_ptr int32 [n_long + 1], the segments of each.  x and out of one
// type (f32 or bf16), rows of ld elements, head z's d columns from z * d
// ([., ld] and [n_rows, ld], ld >= heads * d); partial f32 [heads, n_seg,
// d] scratch (null when n_seg is 0); all contiguous.  accumulate: 0
// writes the listed rows, 1 adds into them.  vec (elements per load: 1,
// 2, 4, and 8 for bf16) must divide d and ld and keep x and out aligned;
// stripe_vectors in {16, 32, 64, 128}; mode 0 (kRegs2), or 1 (kRegs4) and
// 2 (kRing) with 16-byte words.  Launches on `device` and `stream` (a
// second, small kernel when n_long > 0); returns cudaGetLastError() after
// the launches, or cudaErrorInvalidValue for a configuration it does not
// take.
extern "C" int csr_spmm_f32(const void* rowptr, const void* col,
                            const void* w, long long w_head_stride,
                            const void* short_rows, int n_short,
                            const void* seg, int n_seg,
                            const void* long_rows, const void* long_seg_ptr,
                            int n_long, const void* x, void* out,
                            void* partial, int d, long long ld, int heads,
                            int accumulate, int vec, int stripe_vectors,
                            int mode, int device, void* stream) {
  const Args a{rowptr, col, w, w_head_stride, short_rows, n_short, seg,
               n_seg, long_rows, long_seg_ptr, n_long, x, out, partial, d,
               ld, heads, accumulate, static_cast<cudaStream_t>(stream)};
  return on_device(device, [&] {
    switch (vec) {
      case 4: return by_mode<float, 4>(a, stripe_vectors, mode);
      case 2: return by_mode<float, 2>(a, stripe_vectors, mode);
      case 1: return by_mode<float, 1>(a, stripe_vectors, mode);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

extern "C" int csr_spmm_bf16(const void* rowptr, const void* col,
                             const void* w, long long w_head_stride,
                             const void* short_rows, int n_short,
                             const void* seg, int n_seg,
                             const void* long_rows, const void* long_seg_ptr,
                             int n_long, const void* x, void* out,
                             void* partial, int d, long long ld, int heads,
                             int accumulate, int vec, int stripe_vectors,
                             int mode, int device, void* stream) {
  const Args a{rowptr, col, w, w_head_stride, short_rows, n_short, seg,
               n_seg, long_rows, long_seg_ptr, n_long, x, out, partial, d,
               ld, heads, accumulate, static_cast<cudaStream_t>(stream)};
  return on_device(device, [&] {
    switch (vec) {
      case 8: return by_mode<__nv_bfloat16, 8>(a, stripe_vectors, mode);
      case 4: return by_mode<__nv_bfloat16, 4>(a, stripe_vectors, mode);
      case 2: return by_mode<__nv_bfloat16, 2>(a, stripe_vectors, mode);
      case 1: return by_mode<__nv_bfloat16, 1>(a, stripe_vectors, mode);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}
