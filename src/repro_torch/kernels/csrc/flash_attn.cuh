// What flash_attn.cu (the forward) and flash_attn_bwd.cu (the backward)
// share: the operands, the visibility rule and its ranges, the f32 route's
// row loads, the launch with dynamic shared memory and the width switch.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kMasked = -1e30f;

struct Attn {
  const void* q;
  const void* k;
  const void* v;
  int B, S, Hq, Hkv, causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(const Attn& a, int i, int j) {
  return j < a.S && (!a.causal || j <= i) && (a.window == 0 || i - j < a.window);
}

// key range [lo, hi) a query range [q0, q1) can see
__device__ __forceinline__ void key_range(const Attn& a, int q0, int q1,
                                          int& lo, int& hi) {
  lo = a.window ? max(0, q0 - a.window + 1) : 0;
  hi = a.causal ? min(a.S, q1) : a.S;
}

// query range [lo, hi) that sees a key of [k0, k1)
__device__ __forceinline__ void query_range(const Attn& a, int k0, int k1,
                                            int& lo, int& hi) {
  lo = a.causal ? k0 : 0;
  hi = a.window ? min(a.S, k1 - 1 + a.window) : a.S;
}

// ---------------------------------------------------------------------------
// f32: a thread a row, f32 FMAs
// ---------------------------------------------------------------------------

constexpr int kRowsF32 = 32;    // rows a block (one warp)
constexpr int kTileF32 = 32;    // keys (queries) a step

// rows [r0, r0 + n) of x [B, S, H, D] at head h into s[n][ld] (zeros past S)
template <int D>
__device__ __forceinline__ void load_rows_f32(float* s, int ld, const float* x,
                                              int b, int S, int H, int h,
                                              int r0, int n) {
  for (int idx = threadIdx.x; idx < n * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    const int i = r0 + r;
    s[r * ld + d] =
        i < S ? x[((static_cast<size_t>(b) * S + i) * H + h) * D + d] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K, typename... Args>
int launch_with_smem(K kernel, dim3 grid, dim3 block, size_t smem,
                     cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, block, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// the listed (Dqk, Dv) pairs
#define BY_WIDTHS(F)                              \
  if (dqk == 32 && dv == 32) return F(32, 32);    \
  if (dqk == 48 && dv == 32) return F(48, 32);    \
  if (dqk == 64 && dv == 64) return F(64, 64);    \
  if (dqk == 96 && dv == 96) return F(96, 96);    \
  if (dqk == 128 && dv == 128) return F(128, 128); \
  if (dqk == 192 && dv == 128) return F(192, 128); \
  return static_cast<int>(cudaErrorInvalidValue);

inline bool bad(int B, int S, int Hq, int Hkv, int causal, int window) {
  return B < 1 || B > 65535 || S < 1 || Hq < 1 || Hq > 65535 || Hkv < 1 ||
         Hq % Hkv != 0 || window < 0 || (window > 0 && !causal);
}

}  // namespace
