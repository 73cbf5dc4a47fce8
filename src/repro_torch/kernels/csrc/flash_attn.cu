// Flash attention's forward for Hopper (sm_90a): causal or not, an
// optional sliding window, GQA and MLA's unequal widths.  The backward is
// flash_attn_bwd.cu; flash_attn.cuh holds what the two share.
//
// For q [B, S, Hq, Dqk], k [B, S, Hkv, Dqk], v [B, S, Hkv, Dv] (the JAX
// layout, contiguous), rep = Hq / Hkv, query head h reading KV head
// h / rep (`repeat_interleave`'s map), and key j visible to query i when
//
//   j < S  and  (not causal or j <= i)  and  (window == 0 or i - j < window)
//
//   s[i, j] = (q_i . k_j) * scale        (f32; scale the f32 1 / sqrt(Dqk))
//   o_i     = sum_j softmax_j(s[i, .]) v_j   over the visible j, divided by
//             max(l, 1e-20) as the reference does; lse_i = m_i + log(l_i)
//
// `fwd`: a block per (q tile, query head, batch row) walks the key tiles
// that hold a visible key (tiles wholly outside the causal triangle or the
// band are skipped), an online softmax in f32 registers; writes o (q's
// dtype) and lse [B, Hq, S] (f32) for the backward.
//
// It replaces no Pallas TPU kernel: the reference's attention is a chunked
// loop (`lax.map` over query chunks, `lax.scan` over KV chunks,
// `jax.checkpoint` on each step) that XLA compiles
// (src/repro/models/transformer/attention.py:59 `blocked_attention`, :127
// `banded_attention`).  The port's plain version is kernels/ref.py's
// `flash_attention_ref` (the same loops).
//
// What bounds it on the H100: operations (qwen3-1.7b's 4,096-token prefill:
// 69 GFLOP causal forward against 50 MB of q, k, v and o).  Two routes:
//  - bf16 operands: tensor cores through `mma.sync` m16n8k16 with f32
//    accumulators.  Q K^T takes the bf16 operands as they are (its
//    products are exact); P V takes the f32 factor P as two bf16 parts,
//    hi = bf16(x) and lo = bf16(x - hi), two products each: 16 bits of the
//    factor, more than tf32's 11, and the bf16 one exact, so the result
//    differs from the f32 plain version by less than its own bf16
//    rounding.  A warp owns 16 rows of a 64-row tile (four warps a block);
//    tiles of 64 keys go through shared memory by cp.async, two stages in
//    flight, rows padded by 16 bytes; every fragment is one `ldmatrix`
//    (`.trans` for P V's B), the padding putting its eight rows on
//    distinct banks.  The C fragment of Q K^T is the A fragment of P V:
//    its two n8 tiles are a k16 step;
//  - f32 operands: true f32 arithmetic on the CUDA cores (no TF32), a
//    thread a row, the tiles in shared memory (the parity runs and checks
//    use it; their sizes are small).
// `wgmma` and TMA (csrc/hopper.cuh, as the backward uses them) are later
// work.
//
// Head widths (Dqk, Dv), those of every config of src/repro_torch/configs,
// full and reduced: (32, 32), (48, 32), (64, 64), (96, 96), (128, 128) and
// (192, 128).  Any other raises in the wrapper and is refused here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_attn.cuh"
#include "on_device.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// f32: a thread a row, f32 FMAs
// ---------------------------------------------------------------------------

template <int DQK, int DV>
__global__ void __launch_bounds__(kRowsF32)
    fwd_f32(Attn a, float* __restrict__ o, float* __restrict__ lse) {
  constexpr int QL = DQK + 1, OL = DV + 1;
  extern __shared__ float sh[];
  float* Qs = sh;                              // [rows][QL]
  float* Os = Qs + kRowsF32 * QL;              // [rows][OL]
  float* Ks = Os + kRowsF32 * OL;              // [tile][DQK]
  float* Vs = Ks + kTileF32 * DQK;             // [tile][DV]
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv), t = threadIdx.x;
  const int q0 = qt * kRowsF32, i = q0 + t;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  load_rows_f32<DQK>(Qs, QL, q, b, a.S, a.Hq, h, q0, kRowsF32);
  for (int d = 0; d < DV; ++d) Os[t * OL + d] = 0.f;
  int lo, hi;
  key_range(a, q0, q0 + kRowsF32, lo, hi);
  float m = kMasked, l = 0.f;
  for (int k0 = lo - lo % kTileF32; k0 < hi; k0 += kTileF32) {
    __syncthreads();
    load_rows_f32<DQK>(Ks, DQK, k, b, a.S, a.Hkv, hk, k0, kTileF32);
    load_rows_f32<DV>(Vs, DV, v, b, a.S, a.Hkv, hk, k0, kTileF32);
    __syncthreads();
    float sc[kTileF32];
    float mt = m;
#pragma unroll
    for (int j = 0; j < kTileF32; ++j) {
      float s = 0.f;
      for (int d = 0; d < DQK; ++d) s = fmaf(Qs[t * QL + d], Ks[j * DQK + d], s);
      s = visible(a, i, k0 + j) ? s * a.scale : kMasked;
      sc[j] = s;
      mt = fmaxf(mt, s);
    }
    const float corr = expf(m - mt);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < kTileF32; ++j) {
      sc[j] = expf(sc[j] - mt);
      ls += sc[j];
    }
    l = l * corr + ls;
    m = mt;
    for (int d = 0; d < DV; ++d) {
      float x = Os[t * OL + d] * corr;
#pragma unroll
      for (int j = 0; j < kTileF32; ++j) x = fmaf(sc[j], Vs[j * DV + d], x);
      Os[t * OL + d] = x;
    }
  }
  if (i < a.S) {
    const float den = fmaxf(l, 1e-20f);
    float* orow = o + ((static_cast<size_t>(b) * a.S + i) * a.Hq + h) * DV;
    for (int d = 0; d < DV; ++d) orow[d] = Os[t * OL + d] / den;
    lse[(static_cast<size_t>(b) * a.Hq + h) * a.S + i] = m + logf(l);
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync, four warps of 16 rows a block
// ---------------------------------------------------------------------------

constexpr int kRows = 64;       // query rows a block
constexpr int kTile = 64;       // keys a step
constexpr int kPad = 8;         // elements a shared row is padded by

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory, a lane's row address each
// (lanes 8i .. 8i + 7 the rows of matrix i); `trans`: each transposed
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;       // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + n) of x [B, S, H, D] (bf16) at head h into s[n][D + kPad]
// by 16-byte cp.async (zeros past S)
template <int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* x, int b, int S,
                                          int H, int h, int r0, int n) {
  constexpr int C = D / 8;           // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < n * C; idx += blockDim.x) {
    const int r = idx / C, c = idx % C;
    const int i = r0 + r;
    const bf16* src =
        i < S ? x + ((static_cast<size_t>(b) * S + i) * H + h) * D + c * 8 : x;
    cp_async16(s + r * (D + kPad) + c * 8, src, i < S);
  }
}

// Fragments of a bf16 tile s with leading dimension ld, for m16n8k16 (a
// lane's g = lane / 4, t = lane % 4 as in PTX's fragment layouts):
//  - frag_a: A of rows [row, row + 16) x columns [c, c + 16);
//  - frag_b2: B of two n8 tiles, rows [n, n + 16) of s as the n index and
//    columns [c, c + 16) as k (s holds B^T: K for Q K^T);
//  - frag_bt2: B of two n8 tiles, rows [k, k + 16) of s as k and columns
//    [c, c + 16) as n (s holds B: V for P V).
// Each is one ldmatrix.x4; rows padded by 16 bytes hit every bank once.
__device__ __forceinline__ void frag_a(uint32_t (&f)[4], const bf16* s, int ld,
                                       int row, int c) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  ldsm4(f, s + (row + (i & 1) * 8 + (lane & 7)) * ld + c + (i >> 1) * 8);
}

__device__ __forceinline__ void frag_b2(uint32_t (&f)[4], const bf16* s,
                                        int ld, int n, int c) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  ldsm4(f, s + (n + (i >> 1) * 8 + (lane & 7)) * ld + c + (i & 1) * 8);
}

__device__ __forceinline__ void frag_bt2(uint32_t (&f)[4], const bf16* s,
                                         int ld, int k, int c) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  ldsm4_t(f, s + (k + (i & 1) * 8 + (lane & 7)) * ld + c + (i >> 1) * 8);
}

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

// two n8 tiles of C (columns 0-7 and 8-15 of a k16 step) as the A
// fragment of that step, split into its bf16 hi and lo parts
__device__ __forceinline__ void c_as_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float (&c0)[4],
                                       const float (&c1)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// acc[N / 8] += (hi + lo) B over one k16 step, B the columns [0, N) of
// rows [k, k + 16) of s (frag_bt2)
template <int N>
__device__ __forceinline__ void mma_split(float (&acc)[N / 8][4],
                                          const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4],
                                          const bf16* s, int ld, int k) {
#pragma unroll
  for (int n = 0; n < N / 8; n += 2) {
    uint32_t b[4];
    frag_bt2(b, s, ld, k, n * 8);
    mma_bf16(acc[n], hi, b[0], b[1]);
    mma_bf16(acc[n], lo, b[0], b[1]);
    mma_bf16(acc[n + 1], hi, b[2], b[3]);
    mma_bf16(acc[n + 1], lo, b[2], b[3]);
  }
}

// acc[M / 8] += A B^T over columns [0, D) of both: A the warp's 16 rows
// of sa from row ra, B^T rows [0, M) of sb (Q K^T, dO V^T, ...)
template <int D, int M>
__device__ __forceinline__ void mma_abt(float (&acc)[M / 8][4],
                                        const bf16* sa, int lda, int ra,
                                        const bf16* sb, int ldb) {
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t af[4];
    frag_a(af, sa, lda, ra, kk);
#pragma unroll
    for (int n = 0; n < M / 8; n += 2) {
      uint32_t bf[4];
      frag_b2(bf, sb, ldb, n * 8, kk);
      mma_bf16(acc[n], af, bf[0], bf[1]);
      mma_bf16(acc[n + 1], af, bf[2], bf[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// rows i0 (c[0], c[1]) and i0 + 8 (c[2], c[3]) of acc * mul, columns
// 8n + 2t, + 1, into out rows of `stride` elements (past S: not written)
template <int N>
__device__ __forceinline__ void store_rows(bf16* out, size_t stride,
                                           const float (&acc)[N][4], int i0,
                                           int S, const float (&mul)[2],
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (i0 + 8 * r >= S) continue;
    bf16* row = out + (i0 + 8 * r) * stride;
#pragma unroll
    for (int n = 0; n < N; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r] * mul[r],
                                acc[n][2 * r + 1] * mul[r]);
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(128)
    fwd_bf16(Attn a, bf16* __restrict__ o, float* __restrict__ lse) {
  constexpr int QL = DQK + kPad, VL = DV + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);        // [kRows][QL]
  bf16* Ks = Qs + kRows * QL;                      // [2][kTile][QL]
  bf16* Vs = Ks + 2 * kTile * QL;                  // [2][kTile][VL]
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kRows, wr = warp * 16;
  const int i0 = q0 + wr + g, i1 = i0 + 8;         // this thread's rows
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  int lo, hi;
  key_range(a, q0, q0 + kRows, lo, hi);
  const int kt0 = lo / kTile, kt1 = (hi + kTile - 1) / kTile;
  load_tile<DQK>(Qs, q, b, a.S, a.Hq, h, q0, kRows);
  load_tile<DQK>(Ks, k, b, a.S, a.Hkv, hk, kt0 * kTile, kTile);
  load_tile<DV>(Vs, v, b, a.S, a.Hkv, hk, kt0 * kTile, kTile);
  cp_commit();

  float acc[DV / 8][4];
  zero(acc);
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      load_tile<DQK>(Ks + (st ^ 1) * kTile * QL, k, b, a.S, a.Hkv, hk,
                     (kt + 1) * kTile, kTile);
      load_tile<DV>(Vs + (st ^ 1) * kTile * VL, v, b, a.S, a.Hkv, hk,
                    (kt + 1) * kTile, kTile);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + st * kTile * QL;
    const bf16* Vt = Vs + st * kTile * VL;

    float s[kTile / 8][4];
    zero(s);
    mma_abt<DQK, kTile>(s, Qs, QL, wr, Kt, QL);
    const int k0 = kt * kTile;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? i0 : i1, j = k0 + n * 8 + 2 * t + (e & 1);
        const float x = visible(a, i, j) ? s[n][e] * a.scale : kMasked;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float ls[2] = {0.f, 0.f}, corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = __expf(m[r] - mx[r]);
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - mx[e >> 1]);
        ls[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 1);
      ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
      l[r] = l[r] * corr[r] + ls[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; n += 2) {
      uint32_t ph[4], pl[4];
      c_as_a(ph, pl, s[n], s[n + 1]);
      mma_split<DV>(acc, ph, pl, Vt, VL, n * 8);
    }
    __syncthreads();
  }

  const float inv[2] = {1.f / fmaxf(l[0], 1e-20f), 1.f / fmaxf(l[1], 1e-20f)};
  store_rows(o + ((static_cast<size_t>(b) * a.S) * a.Hq + h) * DV,
             static_cast<size_t>(a.Hq) * DV, acc, i0, a.S, inv, t);
  if (t == 0) {
    const size_t row = (static_cast<size_t>(b) * a.Hq + h) * a.S;
    if (i0 < a.S) lse[row + i0] = m[0] + logf(l[0]);
    if (i1 < a.S) lse[row + i1] = m[1] + logf(l[1]);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int DQK, int DV>
int fwd(const Attn& a, void* o, void* lse, bool b16, cudaStream_t st) {
  if (b16) {
    const dim3 grid((a.S + kRows - 1) / kRows, a.Hq, a.B);
    const size_t smem = sizeof(bf16) * (3 * kRows * (DQK + kPad) +
                                        2 * kTile * (DV + kPad));
    return launch_with_smem(fwd_bf16<DQK, DV>, grid, dim3(128), smem, st, a,
                            static_cast<bf16*>(o), static_cast<float*>(lse));
  }
  const dim3 grid((a.S + kRowsF32 - 1) / kRowsF32, a.Hq, a.B);
  const size_t smem = sizeof(float) * (kRowsF32 * (DQK + 1 + DV + 1) +
                                       kTileF32 * (DQK + DV));
  return launch_with_smem(fwd_f32<DQK, DV>, grid, dim3(kRowsF32), smem, st, a,
                          static_cast<float*>(o), static_cast<float*>(lse));
}

}  // namespace

// q [B, S, Hq, dqk], k [B, S, Hkv, dqk], v [B, S, Hkv, dv] contiguous, all
// bf16 when `is_bf16`, else all f32; writes o [B, S, Hq, dv] (their dtype) and
// lse f32 [B, Hq, S].  window 0: none (else causal must be set).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int S, int Hq,
                                   int Hkv, int dqk, int dv, int causal,
                                   int window, float scale, int is_bf16,
                                   int device, void* stream) {
  if (bad(B, S, Hq, Hkv, causal, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const Attn a{q, k, v, B, S, Hq, Hkv, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
#define CALL(DQ, DVV) fwd<DQ, DVV>(a, o, lse, is_bf16 != 0, st)
    BY_WIDTHS(CALL)
#undef CALL
  });
}
