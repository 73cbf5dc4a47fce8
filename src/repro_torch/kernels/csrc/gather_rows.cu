// Row gather for Hopper (sm_90a), bit-exact:  out[i, :] = src[idx[i], :]
//
// Replaces the TPU kernel `_kernel` of `gather_rows_pallas` in
// src/repro/kernels/cache_gather.py (the pallas_call at line 38).
//
// What bounds it on the H100: bytes (no arithmetic at all), and at the
// serving slice's shapes (at most 64 rows of 7 f32 logits per micro-batch,
// 1.8 KB) the launch: the device copies a micro-batch in about a
// microsecond, the host spends several times that on each call.  The host
// side (kernels/cache_gather.py) therefore keeps to what each call needs:
// one combined check, the output's allocation, the raw current stream of
// src's device and one ctypes call; this entry point switches the device
// only when the caller's current device is another one.  The TPU kernel
// kept an n_src x 128 stripe of src in VMEM and padded rows and columns to
// 128; this kernel reads only the rows it copies, straight from HBM/L2,
// and pads nothing:
//  - each row moves as raw words of 16 bytes where the row width and both
//    base addresses allow (f32 at d = 500, the width of the coming p2p
//    halo pack), else of 8, 4 or 2, which keeps the copy bit-exact for
//    any element type;
//  - a row takes the fewest lanes (a power of two up to 32) that cover its
//    words once, so one warp copies several short rows (4 rows of 7 f32
//    logits) and neighbouring lanes touch neighbouring words;
//  - an index outside [0, n_src) yields a row of zero bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "on_device.cuh"

namespace {

constexpr int kThreads = 256;

template <typename W>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const W* __restrict__ src, const int32_t* __restrict__ idx,
                   W* __restrict__ out, int n_out, int n_src, int words,
                   int lanes_log2) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row = t >> lanes_log2;
  if (row >= n_out) return;
  const int lanes = 1 << lanes_log2;
  const int lane = static_cast<int>(t & (lanes - 1));
  const int s = __ldg(idx + row);
  W* orow = out + row * words;
  if (s < 0 || s >= n_src) {
    for (int f = lane; f < words; f += lanes) orow[f] = W{};
    return;
  }
  const W* srow = src + static_cast<int64_t>(s) * words;
  for (int f = lane; f < words; f += lanes) orow[f] = __ldg(srow + f);
}

template <typename W>
int launch(const void* src, const int32_t* idx, void* out, int n_out,
           int n_src, long long row_bytes, cudaStream_t stream) {
  const int words = static_cast<int>(row_bytes / sizeof(W));
  int lanes_log2 = 0;
  while (lanes_log2 < 5 && (1 << lanes_log2) < words) ++lanes_log2;
  const int64_t threads = static_cast<int64_t>(n_out) << lanes_log2;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  gather_rows_kernel<W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const W*>(src), idx, static_cast<W*>(out), n_out, n_src,
      words, lanes_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src [n_src, row_bytes] and out [n_out, row_bytes] contiguous; idx int32
// [n_out].  The word is the widest of 16, 8, 4 or 2 bytes that divides
// row_bytes and both base addresses.  Launches on `device` and `stream`
// (the caller's device back afterwards); returns cudaGetLastError(), or
// cudaErrorInvalidValue when no such word exists.
extern "C" int gather_rows(const void* src, const void* idx, void* out,
                           int n_out, int n_src, long long row_bytes,
                           int device, void* stream) {
  const uint64_t align = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(out) |
                         static_cast<uint64_t>(row_bytes);
  auto i = static_cast<const int32_t*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (align % 16 == 0)
      return launch<uint4>(src, i, out, n_out, n_src, row_bytes, s);
    if (align % 8 == 0)
      return launch<uint2>(src, i, out, n_out, n_src, row_bytes, s);
    if (align % 4 == 0)
      return launch<unsigned int>(src, i, out, n_out, n_src, row_bytes, s);
    if (align % 2 == 0)
      return launch<unsigned short>(src, i, out, n_out, n_src, row_bytes, s);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}
