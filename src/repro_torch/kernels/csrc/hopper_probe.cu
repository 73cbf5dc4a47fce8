// Card probes of csrc/hopper.cuh's primitives, each on its own, for the
// card tests (tests/test_torch_cuda.py, `hopper` tests); no model path
// calls them, so kernels/build.SOURCES leaves this file out and a test
// builds it on first use.
//  - `hopper_probe_tma`: one TMA load of a tile of x [B, S, H, D] bf16 (the
//    boxes of tile_map) into shared memory under an mbarrier, its raw
//    bytes copied out (the 128-byte swizzle as stored), then one TMA
//    store of it back into a tensor of x's shape;
//  - `hopper_probe_wgmma`: a tile t [R][DT] loaded once by a producer
//    warpgroup (setmaxnreg down) and read twice by a consumer warpgroup
//    (setmaxnreg up): c1 = a1 t^T with both operands from shared memory
//    (t K-major, as flash_attn_bwd.cu reads Q in S^T = K Q^T) and c2 = a2
//    t with a2's A fragments in registers (t MN-major, as it reads Q in
//    dK += dS^T Q), 64 columns of t at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "on_device.cuh"

namespace {

using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(128)
    tma_probe(const __grid_constant__ CUtensorMap src,
              const __grid_constant__ CUtensorMap dst, bf16* __restrict__ raw,
              int boxes, int rows, int s0, int h, int b) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_1024(smem_raw);
  const int bytes = boxes * rows * 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + bytes);
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(bar, bytes);
    for (int c = 0; c < boxes; ++c)
      hopper::tma_load_4d(sm + c * rows * 128, &src, bar, 64 * c, h, s0, b);
  }
  hopper::mbar_wait(bar, 0);
  const bf16* tile = reinterpret_cast<const bf16*>(sm);
  for (int i = threadIdx.x; i < bytes / 2; i += blockDim.x) raw[i] = tile[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::fence_async_shared();
    for (int c = 0; c < boxes; ++c)
      hopper::tma_store_4d(&dst, sm + c * rows * 128, 64 * c, h, s0, b);
    hopper::tma_store_wait();
  }
}

template <int R, int DT>
__global__ void __launch_bounds__(256)
    wgmma_probe(const __grid_constant__ CUtensorMap mt,
                const __grid_constant__ CUtensorMap ma,
                const bf16* __restrict__ a2, float* __restrict__ c1,
                float* __restrict__ c2) {
  constexpr int NB = (DT + 63) / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_1024(smem_raw);
  const uint32_t ts = hopper::smem_u32(sm), as = ts + NB * R * 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + NB * (R + 64) * 128);
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= 128) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 128) {
      hopper::mbar_arrive_expect_tx(bar, NB * (R + 64) * 128);
      for (int c = 0; c < NB; ++c) {
        hopper::tma_load_4d(sm + c * R * 128, &mt, bar, 64 * c, 0, 0, 0);
        hopper::tma_load_4d(sm + NB * R * 128 + c * 64 * 128, &ma, bar,
                            64 * c, 0, 0, 0);
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3, r0 = 16 * warp + g;
    hopper::mbar_wait(bar, 0);

    float s[R / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk)
      hopper::wgmma_ss<R, 0>(s, hopper::desc_kmajor(as, 64, 0, kk),
                             hopper::desc_kmajor(ts, R, 0, kk), kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        c1[(r0 + 8 * (e >> 1)) * R + 8 * n + 2 * t + (e & 1)] = s[4 * n + e];

    uint32_t af[R / 16][4];
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        af[kk][q] = *reinterpret_cast<const uint32_t*>(
            a2 + (r0 + 8 * (q & 1)) * R + 16 * kk + 8 * (q >> 1) + 2 * t);
    float d[NB][32];
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk)
        hopper::wgmma_rs<1>(d[c], af[kk], hopper::desc_mnmajor(ts, R, c, kk),
                            kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      hopper::fence_regs(d[c]);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c2[(r0 + 8 * (e >> 1)) * (64 * NB) + 64 * c + 8 * n + 2 * t +
             (e & 1)] = d[c][4 * n + e];
    }
  }
}

template <int R, int DT>
int wgmma_launch(const void* t, const void* a1, const void* a2, void* c1,
                 void* c2, cudaStream_t st) {
  CUtensorMap mt, ma;
  int err = hopper::tile_map(&mt, t, 1, R, 1, DT, R);
  if (err == 0) err = hopper::tile_map(&ma, a1, 1, 64, 1, DT, 64);
  if (err != 0) return err;
  const int smem = ((DT + 63) / 64) * (R + 64) * 128 + 8 + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      wgmma_probe<R, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  wgmma_probe<R, DT><<<1, 256, smem, st>>>(
      mt, ma, static_cast<const bf16*>(a2), static_cast<float*>(c1),
      static_cast<float*>(c2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, S, H, D] bf16 contiguous; back x's shape (rows outside the tile
// untouched), raw [ceil(D / 64)][rows][64] bf16: the tile at (s0, h, b)
extern "C" int hopper_probe_tma(const void* x, void* back, void* raw, int B,
                                int S, int H, int D, int rows, int s0, int h,
                                int b, int device, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    CUtensorMap src, dst;
    int err = hopper::tile_map(&src, x, B, S, H, D, rows);
    if (err == 0) err = hopper::tile_map(&dst, back, B, S, H, D, rows);
    if (err != 0) return err;
    const int boxes = (D + 63) / 64, smem = boxes * rows * 128 + 8 + 1024;
    cudaError_t e = cudaFuncSetAttribute(
        tma_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    tma_probe<<<1, 128, smem, st>>>(src, dst, static_cast<bf16*>(raw), boxes,
                                    rows, s0, h, b);
    return static_cast<int>(cudaGetLastError());
  });
}

// t [r][dt], a1 [64][dt], a2 [64][r] bf16 contiguous; c1 = a1 t^T f32
// [64][r], c2 = a2 t f32 [64][64 ceil(dt / 64)] (columns past dt: 0)
extern "C" int hopper_probe_wgmma(const void* t, const void* a1,
                                  const void* a2, void* c1, void* c2, int r,
                                  int dt, int device, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    if (r == 64 && dt == 64) return wgmma_launch<64, 64>(t, a1, a2, c1, c2, st);
    if (r == 64 && dt == 128)
      return wgmma_launch<64, 128>(t, a1, a2, c1, c2, st);
    if (r == 64 && dt == 192)
      return wgmma_launch<64, 192>(t, a1, a2, c1, c2, st);
    if (r == 32 && dt == 192)
      return wgmma_launch<32, 192>(t, a1, a2, c1, c2, st);
    if (r == 32 && dt == 48) return wgmma_launch<32, 48>(t, a1, a2, c1, c2, st);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}
