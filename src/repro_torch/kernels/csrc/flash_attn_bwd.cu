// Flash attention's backward for Hopper (sm_90a), the two launches after
// flash_attn.cu's forward: causal or not, an optional sliding window, GQA
// and MLA's unequal widths.  For the forward's q, k, v, o and lse (its
// head note gives the layout and the visibility rule) and the output's
// cotangent dO, with P = exp(s - lse) recomputed (nothing of size S x S
// is stored), Delta_i = rowsum(dO_i * o_i) and dS = P * (dO V^T - Delta):
//
//   dQ = scale dS K,   dK = scale dS^T Q,   dV = P^T dO
//
// dK and dV summed over the rep query heads of a KV head.  Two kernels:
//  - `bwd_dq`: a block per (q tile, query head, batch row), longest first,
//    computes and writes Delta for its rows, walks the key tiles that hold
//    a visible key and writes dQ;
//  - `bwd_dkdv`: a block per (k tile, KV head, batch row) walks the q
//    tiles of the group's rep query heads that see one of its keys, reads
//    lse and Delta, and writes dK and dV.  The group sum is in registers:
//    no atomics anywhere, so two launches give the same bits.
//
// It replaces no Pallas TPU kernel: the reference's backward is the
// autodiff of its chunked attention loops (src/repro/models/transformer/
// attention.py:59 `blocked_attention`, :127 `banded_attention`).  The
// port's plain version is kernels/ref.py's `flash_attention_bwd_ref` (this
// file's algorithm over the same tiles).
//
// What bounds it on the H100: operations.  Counting the products as
// executed (P and dS as two bf16 parts, below), qwen3-1.7b's 4,096-token
// causal prefill (16 / 8 heads of 128) takes 137.5 GFLOP in `dq` and
// 206.2 in `dkdv`: 0.348 ms at the bf16 tensor cores' 989 TFLOP/s, against
// 0.04 ms to move their 130 MB.  Only `wgmma` reaches that rate, so the
// bf16 route is built on it (csrc/hopper.cuh):
//  - a block is one warpgroup of 64 rows (keys in `dkdv`, queries in
//    `dq`), two blocks an SM, so that one block's masks and exponentials
//    run while the other's products hold the tensor cores.  The block's
//    resident tile (K and V, or Q and dO) comes once by TMA, then a ring
//    of kStages stages: each step's Q and dO tiles (`dkdv`, with the
//    step's lse and Delta rows) or K and V tiles (`dq`), under a full and
//    an empty `mbarrier` a stage.  The first warp refills a stage once
//    every warp has freed it: `dkdv`'s accumulators (dK and dV, 128
//    registers a thread at 128 / 128) leave no registers for a producer
//    warp of its own (one serialized its products), and in `dq` one gained
//    6% at the prefill but lost 6-9% at the training shapes (PERF.md);
//  - the warpgroup runs S^T = K Q^T and dP^T = V dO^T (`dkdv`), or S = Q
//    K^T and dP = dO V^T (`dq`), as `wgmma` with both operands in shared
//    memory (128-byte swizzled TMA boxes read K-major), form P and dS in
//    the accumulator registers, split each into bf16 hi and lo A
//    fragments, and run dV += P^T dO, dK += dS^T Q, or dQ += dS K as
//    register-A `wgmma`s whose B is the same swizzled tile read MN-major:
//    hi = bf16(x), lo = bf16(x - hi), two products each, 16 bits of the
//    factor, so the result differs from the f32 plain version by less
//    than its own bf16 rounding;
//  - a mask on every pair took a third of `dkdv`'s time (PERF.md), so P
//    and dS are formed for every pair of a step and the hidden pairs
//    zeroed after, only in a tile that the diagonal, the band's edge or S
//    cuts (a query past S is no zero-probability row: lse reads 0 there,
//    so it is masked); at qwen3-1.7b's prefill that is 64 of 2,080 tiles
//    a head;
//  - the register-A products run 64 columns at a time (widths below 64,
//    and 96's second half, padded with the TMA's zero columns); `dkdv`
//    takes 64 queries a step, 32 at Dqk 192 (dK's and dV's accumulators
//    take 160 registers a thread there).
// What it does not do yet: overlap a block's own products with its own
// exponentials (two blocks an SM stand in).  128 keys a `dkdv` block were
// slower at every shape measured, 128 queries a `dq` block slower at the
// training shapes (PERF.md).
// The f32 operands keep true f32 arithmetic on the CUDA cores (no TF32), a
// thread a row, the tiles in shared memory (the parity runs and checks use
// it; their sizes are small).
//
// Head widths (Dqk, Dv): flash_attn.cu's.  Any other raises in the wrapper
// and is refused here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_attn.cuh"
#include "hopper.cuh"
#include "on_device.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// f32: a thread a row, f32 FMAs
// ---------------------------------------------------------------------------

template <int DQK, int DV>
__global__ void __launch_bounds__(kRowsF32)
    dq_f32(Attn a, const float* __restrict__ o, const float* __restrict__ dout,
           const float* __restrict__ lse, float* __restrict__ delta,
           float* __restrict__ dq) {
  constexpr int QL = DQK + 1, OL = DV + 1;
  extern __shared__ float sh[];
  float* Qs = sh;                              // [rows][QL]
  float* dQs = Qs + kRowsF32 * QL;             // [rows][QL]
  float* dOs = dQs + kRowsF32 * QL;            // [rows][OL]
  float* Ks = dOs + kRowsF32 * OL;             // [tile][DQK]
  float* Vs = Ks + kTileF32 * DQK;             // [tile][DV]
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv), t = threadIdx.x;
  const int q0 = qt * kRowsF32, i = q0 + t;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  load_rows_f32<DQK>(Qs, QL, q, b, a.S, a.Hq, h, q0, kRowsF32);
  load_rows_f32<DV>(dOs, OL, dout, b, a.S, a.Hq, h, q0, kRowsF32);
  for (int d = 0; d < DQK; ++d) dQs[t * QL + d] = 0.f;
  __syncthreads();
  const size_t row = (static_cast<size_t>(b) * a.Hq + h) * a.S + i;
  float dl = 0.f, ls = 0.f;
  if (i < a.S) {
    const float* orow = o + ((static_cast<size_t>(b) * a.S + i) * a.Hq + h) * DV;
    for (int d = 0; d < DV; ++d) dl = fmaf(dOs[t * OL + d], orow[d], dl);
    delta[row] = dl;
    ls = lse[row];
  }
  int lo, hi;
  key_range(a, q0, q0 + kRowsF32, lo, hi);
  for (int k0 = lo - lo % kTileF32; k0 < hi; k0 += kTileF32) {
    __syncthreads();
    load_rows_f32<DQK>(Ks, DQK, k, b, a.S, a.Hkv, hk, k0, kTileF32);
    load_rows_f32<DV>(Vs, DV, v, b, a.S, a.Hkv, hk, k0, kTileF32);
    __syncthreads();
    for (int j = 0; j < kTileF32; ++j) {
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < DQK; ++d) s = fmaf(Qs[t * QL + d], Ks[j * DQK + d], s);
      for (int d = 0; d < DV; ++d) dp = fmaf(dOs[t * OL + d], Vs[j * DV + d], dp);
      const float p = visible(a, i, k0 + j) ? expf(s * a.scale - ls) : 0.f;
      const float ds = p * (dp - dl);
      for (int d = 0; d < DQK; ++d)
        dQs[t * QL + d] = fmaf(ds, Ks[j * DQK + d], dQs[t * QL + d]);
    }
  }
  if (i < a.S) {
    float* out = dq + ((static_cast<size_t>(b) * a.S + i) * a.Hq + h) * DQK;
    for (int d = 0; d < DQK; ++d) out[d] = dQs[t * QL + d] * a.scale;
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kRowsF32)
    dkdv_f32(Attn a, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv) {
  constexpr int QL = DQK + 1, OL = DV + 1;
  extern __shared__ float sh[];
  float* Ks = sh;                              // [rows][QL], this block's keys
  float* dKs = Ks + kRowsF32 * QL;             // [rows][QL]
  float* Vs = dKs + kRowsF32 * QL;             // [rows][OL]
  float* dVs = Vs + kRowsF32 * OL;             // [rows][OL]
  float* Qs = dVs + kRowsF32 * OL;             // [tile][DQK]
  float* dOs = Qs + kTileF32 * DQK;            // [tile][DV]
  float* Ls = dOs + kTileF32 * DV;             // [tile]
  float* Ds = Ls + kTileF32;                   // [tile]
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int rep = a.Hq / a.Hkv, t = threadIdx.x;
  const int k0 = kt * kRowsF32, j = k0 + t;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  load_rows_f32<DQK>(Ks, QL, k, b, a.S, a.Hkv, hk, k0, kRowsF32);
  load_rows_f32<DV>(Vs, OL, v, b, a.S, a.Hkv, hk, k0, kRowsF32);
  for (int d = 0; d < DQK; ++d) dKs[t * QL + d] = 0.f;
  for (int d = 0; d < DV; ++d) dVs[t * OL + d] = 0.f;
  int lo, hi;
  query_range(a, k0, k0 + kRowsF32, lo, hi);
  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const size_t hrow = (static_cast<size_t>(b) * a.Hq + h) * a.S;
    for (int q0 = lo - lo % kTileF32; q0 < hi; q0 += kTileF32) {
      __syncthreads();
      load_rows_f32<DQK>(Qs, DQK, q, b, a.S, a.Hq, h, q0, kTileF32);
      load_rows_f32<DV>(dOs, DV, dout, b, a.S, a.Hq, h, q0, kTileF32);
      const int qi = q0 + t;
      Ls[t] = qi < a.S ? lse[hrow + qi] : 0.f;
      Ds[t] = qi < a.S ? delta[hrow + qi] : 0.f;
      __syncthreads();
      for (int n = 0; n < kTileF32; ++n) {
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < DQK; ++d) s = fmaf(Qs[n * DQK + d], Ks[t * QL + d], s);
        for (int d = 0; d < DV; ++d) dp = fmaf(dOs[n * DV + d], Vs[t * OL + d], dp);
        const bool vis = q0 + n < a.S && visible(a, q0 + n, j);
        const float p = vis ? expf(s * a.scale - Ls[n]) : 0.f;
        const float ds = p * (dp - Ds[n]);
        for (int d = 0; d < DV; ++d)
          dVs[t * OL + d] = fmaf(p, dOs[n * DV + d], dVs[t * OL + d]);
        for (int d = 0; d < DQK; ++d)
          dKs[t * QL + d] = fmaf(ds, Qs[n * DQK + d], dKs[t * QL + d]);
      }
    }
  }
  if (j < a.S) {
    const size_t at = (static_cast<size_t>(b) * a.S + j) * a.Hkv + hk;
    for (int d = 0; d < DQK; ++d) dk[at * DQK + d] = dKs[t * QL + d] * a.scale;
    for (int d = 0; d < DV; ++d) dv[at * DV + d] = dVs[t * OL + d];
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int kStages = 2;      // ring stages
constexpr int kLine = 128;      // bytes a row of a box (64 bf16)
constexpr int kThreads = 128;   // a block: one warpgroup, 64 rows

// the blocks an SM a kernel's launch bounds ask for: two when its shared
// memory leaves room for a second block, so that one block's masks and
// exponentials run beside the other's products
template <int SMEM>
struct Blocks {
  static constexpr int per_sm = 2 * (SMEM + 1024) <= 232448 ? 2 : 1;
};

// x and y as a bf16 pair hi (round to nearest) and the pair of what is
// left, lo: hi + lo holds 16 bits of each value, more than tf32's 11
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// columns [16 kk, 16 kk + 16) of an m64 accumulator (its n8 groups 2 kk
// and 2 kk + 1) as the A fragment of k-step kk, in bf16 hi and lo parts
template <int N>
__device__ __forceinline__ void acc_as_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                         const float (&c)[N], int kk) {
  split2(c[8 * kk], c[8 * kk + 1], hi[0], lo[0]);
  split2(c[8 * kk + 2], c[8 * kk + 3], hi[1], lo[1]);
  split2(c[8 * kk + 4], c[8 * kk + 5], hi[2], lo[2]);
  split2(c[8 * kk + 6], c[8 * kk + 7], hi[3], lo[3]);
}

// whether every pair of queries [q0, q1) and keys [k0, k1) is visible,
// all below S: such a tile needs no mask
__device__ __forceinline__ bool tile_visible(const Attn& a, int q0, int q1,
                                             int k0, int k1) {
  return q1 <= a.S && k1 <= a.S && (!a.causal || k1 - 1 <= q0) &&
         (a.window == 0 || q1 - 1 - k0 < a.window);
}

// dkdv's P^T and dS^T in place of S^T (p) and dP^T (dp): rows keys j0
// and j0 + 8, columns the step's queries from i0 (their lse and Delta in
// Lt, Dt), every pair taken as visible (dkdv_mask zeroes the others)
template <int N>
__device__ __forceinline__ void dkdv_probs(float (&p)[N], float (&dp)[N],
                                           float scale, const float* Lt,
                                           const float* Dt, int t) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = n * 8 + 2 * t + (e & 1);
      const float x = __expf(p[4 * n + e] * scale - Lt[c]);
      p[4 * n + e] = x;
      dp[4 * n + e] = x * (dp[4 * n + e] - Dt[c]);
    }
  }
}

// P^T and dS^T of the pairs of dkdv_probs' tile that are hidden, or whose
// query is at S or past it, set to 0: key j sees the queries [lo, hi)
template <int N>
__device__ __forceinline__ void dkdv_mask(float (&p)[N], float (&dp)[N],
                                          const Attn& a, int i0, int j0,
                                          int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + 8 * r, lo = a.causal ? j : 0;
    const int hi = j >= a.S ? lo : min(a.S, a.window ? j + a.window : a.S);
    const unsigned span = max(hi - lo, 0);
    const int base = i0 + 2 * t - lo;
#pragma unroll
    for (int n = 0; n < N / 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (static_cast<unsigned>(base + 8 * n + e) >= span) {
          p[4 * n + 2 * r + e] = 0.f;
          dp[4 * n + 2 * r + e] = 0.f;
        }
  }
}

// dq's dS in place of dP (dp), from S (s): rows queries i0 and i0 + 8
// (their lse and Delta in lr, dr), every pair taken as visible (dq_mask
// zeroes the others)
template <int N>
__device__ __forceinline__ void dq_dscores(const float (&s)[N], float (&dp)[N],
                                           float scale, const float (&lr)[2],
                                           const float (&dr)[2]) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = __expf(s[4 * n + e] * scale - lr[e >> 1]);
      dp[4 * n + e] = x * (dp[4 * n + e] - dr[e >> 1]);
    }
  }
}

// dS of the hidden pairs of dq_dscores' tile (keys from k0) set to 0:
// query i sees the keys [lo, hi)
template <int N>
__device__ __forceinline__ void dq_mask(float (&dp)[N], const Attn& a, int i0,
                                        int k0, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    const int lo = a.window ? i - a.window + 1 : 0;   // a window is causal
    const int hi = a.causal ? min(a.S, i + 1) : a.S;
    const unsigned span = max(hi - lo, 0);
    const int base = k0 + 2 * t - lo;
#pragma unroll
    for (int n = 0; n < N / 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (static_cast<unsigned>(base + 8 * n + e) >= span)
          dp[4 * n + 2 * r + e] = 0.f;
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// rows r0 (acc[c][4n], [4n + 1]) and r0 + 8 (acc[c][4n + 2], [4n + 3]) of
// the 64-column chunks of acc * mul, columns 64 c + 8 n + 2 t (+ 1) below
// D, into rows of `out` `stride` elements apart (rows at S and past: not
// written)
template <int D, int C>
__device__ __forceinline__ void store_acc(bf16* out, size_t stride,
                                          const float (&acc)[C][32], int r0,
                                          int S, float mul, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r0 + 8 * r >= S) continue;
    bf16* row = out + static_cast<size_t>(r0 + 8 * r) * stride;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        if (64 * c + 8 * n < D)
          *reinterpret_cast<__nv_bfloat162*>(row + 64 * c + 8 * n + 2 * t) =
              __floats2bfloat162_rn(acc[c][4 * n + 2 * r] * mul,
                                    acc[c][4 * n + 2 * r + 1] * mul);
  }
}

// shared memory of bwd_dkdv: K and V of the block's keys, the ring's
// stages (Q, dO), the stages' lse and Delta rows, the barriers
template <int DQK, int DV>
struct DkdvTiles {
  static constexpr int QB = (DQK + 63) / 64;      // boxes of a q / k row
  static constexpr int VB = (DV + 63) / 64;       // boxes of a v / dO row
  static constexpr int BQ = DQK > 128 ? 32 : 64;  // queries a step
  static constexpr int KR = 64;                   // keys a block
  static constexpr int K_BYTES = QB * KR * kLine, V_BYTES = VB * KR * kLine;
  static constexpr int Q_BYTES = QB * BQ * kLine, DO_BYTES = VB * BQ * kLine;
  static constexpr int STAGE = Q_BYTES + DO_BYTES;
  static constexpr int OFF_V = K_BYTES, OFF_RING = OFF_V + V_BYTES;
  static constexpr int OFF_ROWS = OFF_RING + kStages * STAGE;
  static constexpr int OFF_BAR = OFF_ROWS + kStages * 2 * BQ * 4;
  static constexpr int SMEM = OFF_BAR + (2 * kStages + 1) * 8 + 1024;
};

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads,
                                  Blocks<DkdvTiles<DQK, DV>::SMEM>::per_sm)
    dkdv_wg(Attn a, const __grid_constant__ CUtensorMap mq,
            const __grid_constant__ CUtensorMap mk,
            const __grid_constant__ CUtensorMap mv,
            const __grid_constant__ CUtensorMap mdo,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv) {
  using T = DkdvTiles<DQK, DV>;
  constexpr int BQ = T::BQ, KR = T::KR;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_1024(smem_raw);
  float* Ls = reinterpret_cast<float*>(sm + T::OFF_ROWS);   // [kStages][BQ]
  float* Ds = Ls + kStages * BQ;                             // [kStages][BQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + T::OFF_BAR);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int rep = a.Hq / a.Hkv, k0 = kt * KR;
  int lo, hi;
  query_range(a, k0, k0 + KR, lo, hi);
  const int qt0 = lo / BQ, nq = max(0, (hi + BQ - 1) / BQ - qt0);
  const int steps = rep * nq;        // (query head, q tile) pairs, in turn
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 32);   // the loading warp's lanes
      hopper::mbar_init(&empty[s], 4);   // a lane a warp
    }
    hopper::mbar_init(kv_full, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // K and V of the block's keys, by one thread
  auto load_kv = [&]() {
    hopper::mbar_arrive_expect_tx(kv_full, T::K_BYTES + T::V_BYTES);
    for (int c = 0; c < T::QB; ++c)
      hopper::tma_load_4d(sm + c * KR * kLine, &mk, kv_full, 64 * c, hk, k0,
                          b);
    for (int c = 0; c < T::VB; ++c)
      hopper::tma_load_4d(sm + T::OFF_V + c * KR * kLine, &mv, kv_full,
                          64 * c, hk, k0, b);
  };
  // step it's Q and dO (TMA, by lane 0) and lse and Delta rows (cp.async,
  // zeros past S) into stage it % kStages, by one warp: the stage's full
  // barrier counts the tiles' bytes and the warp's 32 lanes
  auto load_step = [&](int it, int lane) {
    const int st = it % kStages;
    const int h = hk * rep + it / nq, i0 = (qt0 + it % nq) * BQ;
    unsigned char* stage = sm + T::OFF_RING + st * T::STAGE;
    if (lane == 0) {
      hopper::mbar_expect_tx(&full[st], T::STAGE);
      for (int c = 0; c < T::QB; ++c)
        hopper::tma_load_4d(stage + c * BQ * kLine, &mq, &full[st], 64 * c, h,
                            i0, b);
      for (int c = 0; c < T::VB; ++c)
        hopper::tma_load_4d(stage + T::Q_BYTES + c * BQ * kLine, &mdo,
                            &full[st], 64 * c, h, i0, b);
    }
    const size_t row = (static_cast<size_t>(b) * a.Hq + h) * a.S;
    for (int n = lane; n < BQ; n += 32) {
      const int i = i0 + n;
      const size_t at = row + (i < a.S ? i : 0);
      hopper::cp_async4(&Ls[st * BQ + n], lse + at, i < a.S);
      hopper::cp_async4(&Ds[st * BQ + n], delta + at, i < a.S);
    }
    hopper::cp_async_arrive(&full[st]);
    __syncwarp();
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = k0 + 16 * warp + g;             // this thread's keys
  const uint32_t ks = hopper::smem_u32(sm), vs = ks + T::OFF_V;
  if (warp == 0) {
    // the first warp loads K and V and the first stages
    if (lane == 0) load_kv();
    for (int it = 0; it < steps && it < kStages; ++it) load_step(it, lane);
  }
  float dka[T::QB][32], dva[T::VB][32];
#pragma unroll
  for (int c = 0; c < T::QB; ++c) zero(dka[c]);
#pragma unroll
  for (int c = 0; c < T::VB; ++c) zero(dva[c]);
  hopper::mbar_wait(kv_full, 0);

  for (int it = 0; it < steps; ++it) {
    const int st = it % kStages;
    const uint32_t qs = ks + T::OFF_RING + st * T::STAGE;
    const uint32_t dos = qs + T::Q_BYTES;
    const float* Lt = Ls + st * BQ;
    const float* Dt = Ds + st * BQ;
    const int i0 = (qt0 + it % nq) * BQ;
    hopper::mbar_wait(&full[st], (it / kStages) & 1);

    // the operands' addresses, opaque: each descriptor is built where its
    // product is issued, not held in registers across the loop
    uint32_t kb = ks, vb = vs, qb = qs, db = dos;
    asm volatile("" : "+r"(kb), "+r"(vb), "+r"(qb), "+r"(db));

    // S^T = K Q^T and dP^T = V dO^T: rows the block's 64 keys, columns the
    // step's queries
    float p[BQ / 2], dp[BQ / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
      hopper::wgmma_ss<BQ, 0>(p, hopper::desc_kmajor(kb, KR, 0, kk),
                              hopper::desc_kmajor(qb, BQ, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      hopper::wgmma_ss<BQ, 0>(dp, hopper::desc_kmajor(vb, KR, 0, kk),
                              hopper::desc_kmajor(db, BQ, 0, kk), kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(p);
    hopper::fence_regs(dp);
    dkdv_probs(p, dp, a.scale, Lt, Dt, t);
    if (!tile_visible(a, i0, i0 + BQ, k0, k0 + KR))
      dkdv_mask(p, dp, a, i0, j0, t);
    // dV += P^T dO and dK += dS^T Q, each factor in its hi and lo parts, B
    // the stage's dO and Q read MN-major
    uint32_t ph[BQ / 16][4], pl[BQ / 16][4], sh[BQ / 16][4], sl[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      acc_as_a(ph[kk], pl[kk], p, kk);
      acc_as_a(sh[kk], sl[kk], dp, kk);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int c = 0; c < T::VB; ++c) {
        const uint64_t d = hopper::desc_mnmajor(db, BQ, c, kk);
        hopper::wgmma_rs<1>(dva[c], ph[kk], d, 1);
        hopper::wgmma_rs<1>(dva[c], pl[kk], d, 1);
      }
#pragma unroll
      for (int c = 0; c < T::QB; ++c) {
        const uint64_t d = hopper::desc_mnmajor(qb, BQ, c, kk);
        hopper::wgmma_rs<1>(dka[c], sh[kk], d, 1);
        hopper::wgmma_rs<1>(dka[c], sl[kk], d, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < T::QB; ++c) hopper::fence_regs(dka[c]);
#pragma unroll
    for (int c = 0; c < T::VB; ++c) hopper::fence_regs(dva[c]);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
    if (warp == 0 && it + kStages < steps) {
      // the first warp refills the stage once every warp is done with it
      hopper::mbar_wait(&empty[st], (it / kStages) & 1);
      load_step(it + kStages, lane);
    }
  }

  const size_t base = static_cast<size_t>(b) * a.S * a.Hkv + hk;
  store_acc<DQK>(dk + base * DQK, static_cast<size_t>(a.Hkv) * DQK, dka, j0,
                 a.S, a.scale, t);
  store_acc<DV>(dv + base * DV, static_cast<size_t>(a.Hkv) * DV, dva, j0,
                a.S, 1.f, t);
}

// shared memory of bwd_dq: Q and dO of the block's queries, the ring's
// stages (K, V), the rows' lse and Delta, the barriers
template <int DQK, int DV>
struct DqTiles {
  static constexpr int QB = (DQK + 63) / 64, VB = (DV + 63) / 64;
  static constexpr int BK = 64;                   // keys a step
  static constexpr int QR = 64;                   // queries a block
  static constexpr int Q_BYTES = QB * QR * kLine, DO_BYTES = VB * QR * kLine;
  static constexpr int K_BYTES = QB * BK * kLine, V_BYTES = VB * BK * kLine;
  static constexpr int STAGE = K_BYTES + V_BYTES;
  static constexpr int OFF_DO = Q_BYTES, OFF_RING = OFF_DO + DO_BYTES;
  static constexpr int OFF_ROWS = OFF_RING + kStages * STAGE;
  static constexpr int OFF_BAR = OFF_ROWS + 2 * QR * 4;
  static constexpr int SMEM = OFF_BAR + (2 * kStages + 1) * 8 + 1024;
};

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads,
                                  Blocks<DqTiles<DQK, DV>::SMEM>::per_sm)
    dq_wg(Attn a, const __grid_constant__ CUtensorMap mq,
          const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv,
          const __grid_constant__ CUtensorMap mdo, const bf16* __restrict__ o,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, bf16* __restrict__ dq) {
  using T = DqTiles<DQK, DV>;
  constexpr int QR = T::QR, BK = T::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_1024(smem_raw);
  float* Ls = reinterpret_cast<float*>(sm + T::OFF_ROWS);   // [QR]
  float* Ds = Ls + QR;                                       // [QR]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + T::OFF_BAR);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv), q0 = qt * QR;
  int lo, hi;
  key_range(a, q0, q0 + QR, lo, hi);
  const int kt0 = lo / BK, steps = max(0, (hi + BK - 1) / BK - kt0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);   // a lane a warp
    }
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // Q and dO of the block's queries, by one thread
  auto load_q = [&]() {
    hopper::mbar_arrive_expect_tx(q_full, T::Q_BYTES + T::DO_BYTES);
    for (int c = 0; c < T::QB; ++c)
      hopper::tma_load_4d(sm + c * QR * kLine, &mq, q_full, 64 * c, h, q0, b);
    for (int c = 0; c < T::VB; ++c)
      hopper::tma_load_4d(sm + T::OFF_DO + c * QR * kLine, &mdo, q_full,
                          64 * c, h, q0, b);
  };
  // step it's K and V tiles into stage it % kStages, by one thread
  auto load_step = [&](int it) {
    const int st = it % kStages, j0 = (kt0 + it) * BK;
    unsigned char* stage = sm + T::OFF_RING + st * T::STAGE;
    hopper::mbar_arrive_expect_tx(&full[st], T::STAGE);
    for (int c = 0; c < T::QB; ++c)
      hopper::tma_load_4d(stage + c * BK * kLine, &mk, &full[st], 64 * c, hk,
                          j0, b);
    for (int c = 0; c < T::VB; ++c)
      hopper::tma_load_4d(stage + T::K_BYTES + c * BK * kLine, &mv,
                          &full[st], 64 * c, hk, j0, b);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if (threadIdx.x == 0) {
    // one thread loads Q, dO and the first stages
    load_q();
    for (int it = 0; it < steps && it < kStages; ++it) load_step(it);
  }
  __syncwarp();
  // Delta = rowsum(dO * o) in f32: two threads a row, half of it each
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, i = q0 + r;
    float dl = 0.f;
    if (i < a.S) {
      const size_t at = ((static_cast<size_t>(b) * a.S + i) * a.Hq + h) * DV;
      for (int d = half * (DV / 2); d < (half + 1) * (DV / 2); ++d)
        dl = fmaf(__bfloat162float(dout[at + d]), __bfloat162float(o[at + d]),
                  dl);
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    const size_t row = (static_cast<size_t>(b) * a.Hq + h) * a.S + i;
    if (half == 0) {
      Ds[r] = dl;
      Ls[r] = i < a.S ? lse[row] : 0.f;
      if (i < a.S) delta[row] = dl;
    }
  }
  __syncthreads();
  const int rr = 16 * warp + g;
  const int i0 = q0 + rr;                          // this thread's rows
  const float lr[2] = {Ls[rr], Ls[rr + 8]};
  const float dr[2] = {Ds[rr], Ds[rr + 8]};
  const uint32_t qs = hopper::smem_u32(sm), dos = qs + T::OFF_DO;
  float dqa[T::QB][32];
#pragma unroll
  for (int c = 0; c < T::QB; ++c) zero(dqa[c]);
  hopper::mbar_wait(q_full, 0);

  for (int it = 0; it < steps; ++it) {
    const int st = it % kStages, k0 = (kt0 + it) * BK;
    const uint32_t ks = qs + T::OFF_RING + st * T::STAGE;
    const uint32_t vs = ks + T::K_BYTES;
    hopper::mbar_wait(&full[st], (it / kStages) & 1);

    // the operands' addresses, opaque (as in dkdv_wg)
    uint32_t qb = qs, db = dos, kb = ks, vb = vs;
    asm volatile("" : "+r"(kb), "+r"(vb), "+r"(qb), "+r"(db));

    // S = Q K^T and dP = dO V^T: rows the block's 64 queries, columns the
    // step's keys
    float s[BK / 2], dp[BK / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
      hopper::wgmma_ss<BK, 0>(s, hopper::desc_kmajor(qb, QR, 0, kk),
                              hopper::desc_kmajor(kb, BK, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      hopper::wgmma_ss<BK, 0>(dp, hopper::desc_kmajor(db, QR, 0, kk),
                              hopper::desc_kmajor(vb, BK, 0, kk), kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    dq_dscores(s, dp, a.scale, lr, dr);
    if (!tile_visible(a, q0, q0 + QR, k0, k0 + BK)) dq_mask(dp, a, i0, k0, t);
    // dQ += dS K, dS in its hi and lo parts, B the stage's K read MN-major
    uint32_t sh[BK / 16][4], sl[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_as_a(sh[kk], sl[kk], dp, kk);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int c = 0; c < T::QB; ++c) {
        const uint64_t d = hopper::desc_mnmajor(kb, BK, c, kk);
        hopper::wgmma_rs<1>(dqa[c], sh[kk], d, 1);
        hopper::wgmma_rs<1>(dqa[c], sl[kk], d, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < T::QB; ++c) hopper::fence_regs(dqa[c]);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
    if (threadIdx.x == 0 && it + kStages < steps) {
      // the same thread refills the stage once every warp is done with it
      hopper::mbar_wait(&empty[st], (it / kStages) & 1);
      load_step(it + kStages);
    }
    __syncwarp();
  }

  store_acc<DQK>(dq + (static_cast<size_t>(b) * a.S * a.Hq + h) * DQK,
                 static_cast<size_t>(a.Hq) * DQK, dqa, i0, a.S, a.scale, t);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// shared memory of the f32 kernels
template <int DQK, int DV>
constexpr size_t dq_f32_smem() {
  return sizeof(float) * (kRowsF32 * (2 * (DQK + 1) + DV + 1) +
                          kTileF32 * (DQK + DV));
}

template <int DQK, int DV>
constexpr size_t dkdv_f32_smem() {
  return sizeof(float) * (kRowsF32 * 2 * (DQK + 1 + DV + 1) +
                          kTileF32 * (DQK + DV + 2));
}

// maps of x [B, S, H, D] in boxes of [rows][64] (tile_map), in order
inline int maps(const Attn& a, CUtensorMap* m, const void* const* x,
                const int* heads, const int* widths, const int* rows, int n) {
  for (int i = 0; i < n; ++i) {
    const int err = hopper::tile_map(&m[i], x[i], a.B, a.S, heads[i],
                                     widths[i], rows[i]);
    if (err != 0) return err;
  }
  return 0;
}

template <int DQK, int DV>
int bwd_dq(const Attn& a, const void* o, const void* dout, const void* lse,
           void* delta, void* dq, bool b16, cudaStream_t st) {
  if (b16) {
    using T = DqTiles<DQK, DV>;
    CUtensorMap m[4];      // q, k, v, dO
    const void* x[4] = {a.q, a.k, a.v, dout};
    const int heads[4] = {a.Hq, a.Hkv, a.Hkv, a.Hq};
    const int widths[4] = {DQK, DQK, DV, DV};
    const int rows[4] = {T::QR, T::BK, T::BK, T::QR};
    const int err = maps(a, m, x, heads, widths, rows, 4);
    if (err != 0) return err;
    const dim3 grid((a.S + T::QR - 1) / T::QR, a.Hq, a.B);
    return launch_with_smem(dq_wg<DQK, DV>, grid, dim3(kThreads), T::SMEM,
                            st, a, m[0], m[1], m[2], m[3],
                            static_cast<const bf16*>(o),
                            static_cast<const bf16*>(dout),
                            static_cast<const float*>(lse),
                            static_cast<float*>(delta), static_cast<bf16*>(dq));
  }
  const dim3 grid((a.S + kRowsF32 - 1) / kRowsF32, a.Hq, a.B);
  return launch_with_smem(dq_f32<DQK, DV>, grid, dim3(kRowsF32),
                          dq_f32_smem<DQK, DV>(), st, a,
                          static_cast<const float*>(o),
                          static_cast<const float*>(dout),
                          static_cast<const float*>(lse),
                          static_cast<float*>(delta), static_cast<float*>(dq));
}

template <int DQK, int DV>
int bwd_dkdv(const Attn& a, const void* dout, const void* lse,
             const void* delta, void* dk, void* dv, bool b16,
             cudaStream_t st) {
  if (b16) {
    using T = DkdvTiles<DQK, DV>;
    CUtensorMap m[4];      // q, k, v, dO
    const void* x[4] = {a.q, a.k, a.v, dout};
    const int heads[4] = {a.Hq, a.Hkv, a.Hkv, a.Hq};
    const int widths[4] = {DQK, DQK, DV, DV};
    const int rows[4] = {T::BQ, T::KR, T::KR, T::BQ};
    const int err = maps(a, m, x, heads, widths, rows, 4);
    if (err != 0) return err;
    const dim3 grid((a.S + T::KR - 1) / T::KR, a.Hkv, a.B);
    return launch_with_smem(dkdv_wg<DQK, DV>, grid, dim3(kThreads), T::SMEM,
                            st, a, m[0], m[1], m[2], m[3],
                            static_cast<const float*>(lse),
                            static_cast<const float*>(delta),
                            static_cast<bf16*>(dk), static_cast<bf16*>(dv));
  }
  const dim3 grid((a.S + kRowsF32 - 1) / kRowsF32, a.Hkv, a.B);
  return launch_with_smem(dkdv_f32<DQK, DV>, grid, dim3(kRowsF32),
                          dkdv_f32_smem<DQK, DV>(), st, a,
                          static_cast<const float*>(dout),
                          static_cast<const float*>(lse),
                          static_cast<const float*>(delta),
                          static_cast<float*>(dk), static_cast<float*>(dv));
}

// one kernel's registers a thread, the block's shared memory, its local
// (spill) bytes a thread and its threads: out[4]
template <typename K>
int attributes(K kernel, size_t smem, int threads, int* out) {
  cudaFuncAttributes f;
  const cudaError_t err = cudaFuncGetAttributes(&f, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = f.numRegs;
  out[1] = static_cast<int>(smem + f.sharedSizeBytes);
  out[2] = static_cast<int>(f.localSizeBytes);
  out[3] = threads;
  return 0;
}

template <int DQK, int DV>
int bwd_attributes(bool b16, bool dkdv, int* out) {
  if (b16 && dkdv)
    return attributes(dkdv_wg<DQK, DV>, DkdvTiles<DQK, DV>::SMEM, kThreads,
                      out);
  if (b16)
    return attributes(dq_wg<DQK, DV>, DqTiles<DQK, DV>::SMEM, kThreads, out);
  if (dkdv)
    return attributes(dkdv_f32<DQK, DV>, dkdv_f32_smem<DQK, DV>(), kRowsF32,
                      out);
  return attributes(dq_f32<DQK, DV>, dq_f32_smem<DQK, DV>(), kRowsF32, out);
}

}  // namespace

// the kernel attributes of `bwd_dq` (which 0) or `bwd_dkdv` (which 1) at
// (dqk, dv) in bf16 or f32 into out[4] (attributes above), for the records
extern "C" int flash_attention_bwd_attributes(int dqk, int dv, int is_bf16,
                                              int which, int* out,
                                              int device) {
  return on_device(device, [&]() -> int {
#define CALL(DQ, DVV) bwd_attributes<DQ, DVV>(is_bf16 != 0, which != 0, out)
    BY_WIDTHS(CALL)
#undef CALL
  });
}

// the operands of the forward, its o and lse, and dO [B, S, Hq, dv] (q's
// dtype, contiguous, 16-byte aligned when bf16); writes delta f32
// [B, Hq, S] and dq [B, S, Hq, dqk].
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, int B, int S,
                                      int Hq, int Hkv, int dqk, int dv,
                                      int causal, int window, float scale,
                                      int is_bf16, int device, void* stream) {
  if (bad(B, S, Hq, Hkv, causal, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const Attn a{q, k, v, B, S, Hq, Hkv, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
#define CALL(DQ, DVV) bwd_dq<DQ, DVV>(a, o, dout, lse, delta, dq, is_bf16 != 0, st)
    BY_WIDTHS(CALL)
#undef CALL
  });
}

// the operands of the forward, dO, lse and delta (bwd_dq's); writes dk
// [B, S, Hkv, dqk] and dv [B, S, Hkv, dv], each summed over its group.
extern "C" int flash_attention_bwd_dkdv(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv_out, int B, int S,
                                        int Hq, int Hkv, int dqk, int dv,
                                        int causal, int window, float scale,
                                        int is_bf16, int device, void* stream) {
  if (bad(B, S, Hq, Hkv, causal, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const Attn a{q, k, v, B, S, Hq, Hkv, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
#define CALL(DQ, DVV) \
  bwd_dkdv<DQ, DVV>(a, dout, lse, delta, dk, dv_out, is_bf16 != 0, st)
    BY_WIDTHS(CALL)
#undef CALL
  });
}
