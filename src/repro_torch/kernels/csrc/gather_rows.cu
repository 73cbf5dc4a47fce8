// Row gather for Hopper (sm_90a), bit-exact:  out[i, :] = src[idx[i], :]
//
// Replaces the TPU kernel `_kernel` of `gather_rows_pallas` in
// src/repro/kernels/cache_gather.py (the pallas_call at line 38).
//
// What bounds it on the H100: bytes (no arithmetic at all), and at the
// serving slice's shapes (at most 64 rows of 7 f32 logits per micro-batch)
// the launch itself.  The TPU kernel kept an n_src x 128 stripe of src in
// VMEM and padded rows and columns to 128; this kernel reads only the rows
// it copies, straight from HBM/L2, and pads nothing:
//  - one warp per output row, lanes over the row's elements, so each row
//    moves as coalesced segments for any width d (d = 7 on the slice, so
//    no 16-byte alignment is assumed);
//  - elements are copied as raw 2-, 4- or 8-byte words, which makes the
//    copy bit-exact for f32 and bf16 alike;
//  - an index outside [0, n_src) yields a row of zero bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 rows per block

template <typename Word>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Word* __restrict__ src,
                   const int32_t* __restrict__ idx, Word* __restrict__ out,
                   int n_out, int n_src, int d) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_out) return;
  const int s = idx[row];
  Word* orow = out + row * d;
  if (s < 0 || s >= n_src) {
    for (int f = lane; f < d; f += 32) orow[f] = Word(0);
    return;
  }
  const Word* srow = src + static_cast<int64_t>(s) * d;
  for (int f = lane; f < d; f += 32) orow[f] = __ldg(srow + f);
}

template <typename Word>
void launch(const void* src, const int32_t* idx, void* out, int n_out,
            int n_src, int d, cudaStream_t stream) {
  const int rows_per_block = kThreads / 32;
  const unsigned blocks = (n_out + rows_per_block - 1) / rows_per_block;
  gather_rows_kernel<Word><<<blocks, kThreads, 0, stream>>>(
      static_cast<const Word*>(src), idx, static_cast<Word*>(out), n_out,
      n_src, d);
}

}  // namespace

// src [n_src, d] and out [n_out, d] contiguous, of elements `elem_bytes`
// wide; idx int32 [n_out].  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an element width other than 2, 4 or 8.
extern "C" int gather_rows(const void* src, const void* idx, void* out,
                           int n_out, int n_src, int d, int elem_bytes,
                           void* stream) {
  auto i = static_cast<const int32_t*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 2: launch<unsigned short>(src, i, out, n_out, n_src, d, s); break;
    case 4: launch<unsigned int>(src, i, out, n_out, n_src, d, s); break;
    case 8: launch<unsigned long long>(src, i, out, n_out, n_src, d, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
