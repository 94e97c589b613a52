// Float types the kernels read and write, by the code the Python wrappers
// pass (kernels/_build.py:FLOAT_CODES): 0 float32, 1 float16, 2 bfloat16.
// Arithmetic is float32 throughout; these convert at the loads and stores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

enum FloatCode { kF32 = 0, kF16 = 1, kBF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The elements of one 32-bit word (one float32, or two 16-bit values, the
// lower address in the low half) as float32.
template <typename T>
__device__ __forceinline__ void unpack_word(unsigned w, float* f);
template <>
__device__ __forceinline__ void unpack_word<float>(unsigned w, float* f) {
  f[0] = __uint_as_float(w);
}
template <>
__device__ __forceinline__ void unpack_word<__half>(unsigned w, float* f) {
  f[0] = __half2float(__ushort_as_half(static_cast<unsigned short>(w & 0xffffu)));
  f[1] = __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
}
template <>
__device__ __forceinline__ void unpack_word<__nv_bfloat16>(unsigned w, float* f) {
  f[0] = __uint_as_float(w << 16);            // bfloat16 is float32's top half
  f[1] = __uint_as_float(w & 0xffff0000u);
}

// Runs the statements that follow with `T` the type of `code`, or returns
// cudaErrorInvalidValue from the enclosing function for an unknown code:
//   FLOAT_DISPATCH(code, T, launch<T>(...));
#define FLOAT_DISPATCH(code, T, ...)                          \
  switch (code) {                                             \
    case kF32: { using T = float; __VA_ARGS__; } break;        \
    case kF16: { using T = __half; __VA_ARGS__; } break;       \
    case kBF16: { using T = __nv_bfloat16; __VA_ARGS__; } break; \
    default: return static_cast<int>(cudaErrorInvalidValue);  \
  }
