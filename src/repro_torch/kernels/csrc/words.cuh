// Vector words of f32 or bf16 feature rows, shared by the SpMM kernels
// (ell_spmm.cu, csr_spmm.cu): VEC elements moved as one load or store, and
// f32 arithmetic on them.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

// VEC elements of T moved as one word
template <typename T, int VEC> struct Word;
template <> struct Word<float, 4> { using type = float4; };
template <> struct Word<float, 2> { using type = float2; };
template <> struct Word<float, 1> { using type = float; };
template <> struct Word<__nv_bfloat16, 8> { using type = uint4; };
template <> struct Word<__nv_bfloat16, 4> { using type = uint2; };
template <> struct Word<__nv_bfloat16, 2> { using type = unsigned int; };
template <> struct Word<__nv_bfloat16, 1> { using type = unsigned short; };

template <typename T, int VEC>
using word_t = typename Word<T, VEC>::type;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __float2bfloat16(x);
  }
}

// acc[i] += v * (the i-th element of w), in f32
template <typename T, int VEC>
__device__ __forceinline__ void fma_word(float v, const word_t<T, VEC>& w,
                                         float (&acc)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = fmaf(v, to_f32(e[i]), acc[i]);
}

// x[i] += (the i-th element of the word at p), in f32
template <typename T, int VEC>
__device__ __forceinline__ void add_word(const T* p, float (&x)[VEC]) {
  const word_t<T, VEC> w = *reinterpret_cast<const word_t<T, VEC>*>(p);
  const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int i = 0; i < VEC; ++i) x[i] = to_f32(e[i]) + x[i];
}

template <typename T, int VEC>
__device__ __forceinline__ void store_word(T* p, const float (&x)[VEC]) {
  word_t<T, VEC> w;
  T* e = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(x[i]);
  *reinterpret_cast<word_t<T, VEC>*>(p) = w;
}
