// One-token decode attention over a (ring-buffer) KV cache, for Hopper
// (sm_90a), f32 or bf16 operands with f32 arithmetic.
//
// For q [B, 1, Hq, D], caches k, v [B, W, Hkv, D] (the JAX layout) and a
// per-slot mask valid [B, W] (bool, one byte a slot), with rep = Hq / Hkv
// and query head h reading KV head h / rep (`repeat_interleave`'s map):
//
//   s[b, h, w] = (q[b, 0, h] . k[b, w, h / rep]) * scale   (f32; scale the
//                f32 value of 1 / sqrt(D))
//   s          = valid[b, w] ? s : -1e30                    (set, not skipped)
//   out[b, 0, h] = sum_w softmax_w(s) v[b, w, h / rep]      (f32, q's dtype)
//
// so a batch row with no valid slot gets the mean of its V rows, as the
// reference's softmax over -1e30 everywhere does.
//
// It replaces no Pallas TPU kernel: the reference computes it with
// `jnp.repeat`, two einsums and `jax.nn.softmax`
// (src/repro/models/transformer/blocks.py:150 `_decode_attn_ring`,
// src/repro/models/transformer/attention.py:190 `decode_attention`), as the
// port's plain version does (kernels/ref.py: `decode_attention_ref`).
//
// What bounds it on the H100: bytes.  Each cache row is read once (at
// `serve lm`'s step, 4 x 256 slots x 8 KV heads of 128 in bf16: 4 MB a
// layer, 1.25 us at 3.35 TB/s); the arithmetic is 4 flops a cache element
// per query head.  Design: a block per (KV head, batch row) reads each of
// its cache rows once for all rep query heads of the group (no expanded
// cache); its 8 warps take the slots 4 at a time in turns (the 4 rows'
// loads in flight together), a lane D / 32 elements of a
// row (neighbouring lanes on neighbouring elements), the dot products by an
// xor butterfly, a running max, sum and weighted V per query head in
// registers (flash-decoding within the block); the warps' states combine
// through shared memory in a fixed order, so two launches give the same
// bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "on_device.cuh"
#include "words.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxRep = 8;      // query heads a KV head serves, at most
constexpr int kBatch = 4;       // slots a warp loads before scoring them
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc, const uint8_t* __restrict__ valid,
                  T* __restrict__ out, int W, int hkv, int rep, float scale) {
  constexpr int E = D / 32;             // elements of a row a lane holds
  const int j = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hq = hkv * rep;

  float qv[kMaxRep][E], acc[kMaxRep][E], m[kMaxRep], l[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc[r][e] = 0.f;
      qv[r][e] = r < rep ? to_f32(q[(static_cast<size_t>(b) * hq + j * rep +
                                     r) * D + lane + 32 * e])
                         : 0.f;
    }
  }

  // a warp takes kBatch consecutive slots at a time, their rows all
  // loaded before the first is scored (the loads in flight together)
  for (int w0 = warp * kBatch; w0 < W; w0 += kWarps * kBatch) {
    float kr[kBatch][E], vr[kBatch][E];
    bool ok[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int w = min(w0 + u, W - 1);
      const size_t row = ((static_cast<size_t>(b) * W + w) * hkv + j) * D;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kr[u][e] = to_f32(kc[row + lane + 32 * e]);
        vr[u][e] = to_f32(vc[row + lane + 32 * e]);
      }
      ok[u] = valid[static_cast<size_t>(b) * W + w] != 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (w0 + u >= W) break;
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r >= rep) break;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s = fmaf(qv[r][e], kr[u][e], s);
        s = warp_sum(s);
        s = ok[u] ? s * scale : kMasked;
        const float mn = fmaxf(m[r], s);
        const float corr = expf(m[r] - mn);
        const float p = expf(s - mn);
        l[r] = l[r] * corr + p;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[r][e] = fmaf(p, vr[u][e], acc[r][e] * corr);
        m[r] = mn;
      }
    }
  }

  __shared__ float sm[kWarps][kMaxRep], sl[kWarps][kMaxRep];
  __shared__ float sacc[kWarps][kMaxRep][D];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r >= rep) break;
    if (lane == 0) {
      sm[warp][r] = m[r];
      sl[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sacc[warp][r][lane + 32 * e] = acc[r][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rep * D; idx += kWarps * 32) {
    const int r = idx / D, d = idx % D;
    float mx = kMasked;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w][r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm[w][r] - mx);
      den = fmaf(sl[w][r], f, den);
      num = fmaf(sacc[w][r][d], f, num);
    }
    out[(static_cast<size_t>(b) * hq + j * rep + r) * D + d] =
        from_f32<T>(num / den);
  }
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* valid,
           void* out, int B, int W, int hkv, int rep, int D, float scale,
           cudaStream_t st) {
  const dim3 grid(hkv, B);
  const dim3 block(kWarps * 32);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(kc);
  const T* vp = static_cast<const T*>(vc);
  const uint8_t* mp = static_cast<const uint8_t*>(valid);
  T* op = static_cast<T*>(out);
  switch (D) {
    case 32:
      decode_kernel<T, 32><<<grid, block, 0, st>>>(qp, kp, vp, mp, op, W, hkv,
                                                    rep, scale);
      break;
    case 64:
      decode_kernel<T, 64><<<grid, block, 0, st>>>(qp, kp, vp, mp, op, W, hkv,
                                                    rep, scale);
      break;
    case 96:
      decode_kernel<T, 96><<<grid, block, 0, st>>>(qp, kp, vp, mp, op, W, hkv,
                                                    rep, scale);
      break;
    case 128:
      decode_kernel<T, 128><<<grid, block, 0, st>>>(qp, kp, vp, mp, op, W,
                                                     hkv, rep, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, 1, hkv * rep, D], k and v [B, W, hkv, D] (contiguous, one dtype:
// bf16 when `is_bf16`, else f32), valid uint8 [B, W]; writes out [B, 1, hkv *
// rep, D] in q's dtype.  D 32, 64, 96 or 128; rep 1 to 8.
extern "C" int decode_attention(const void* q, const void* kc, const void* vc,
                                const void* valid, void* out, int B, int W,
                                int hkv, int rep, int D, float scale, int is_bf16,
                                int device, void* stream) {
  if (B < 1 || W < 1 || hkv < 1 || rep < 1 || rep > kMaxRep || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    return is_bf16 ? launch<__nv_bfloat16>(q, kc, vc, valid, out, B, W, hkv, rep,
                                        D, scale, st)
                : launch<float>(q, kc, vc, valid, out, B, W, hkv, rep, D,
                                scale, st);
  });
}
