// Shared helpers of the port's CUDA kernels: widening loads from f32 or
// bf16 into f32 registers, narrowing stores, and the error string the
// ctypes wrappers report. Each kernel source includes this header and is
// built into its own shared library (see kernels/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace repro_torch {

// The integer type of one aligned load of a given size in bytes.
template <int Bytes>
struct RawVec;
template <>
struct RawVec<2> { using type = unsigned short; };
template <>
struct RawVec<4> { using type = unsigned int; };
template <>
struct RawVec<8> { using type = uint2; };
template <>
struct RawVec<16> { using type = uint4; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store_from_float(float* p, float x) {
  *p = x;
}
__device__ __forceinline__ void store_from_float(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// out[0..N) = p[0..N) widened to f32, read as ONE vector load; p must
// be aligned to N elements.
template <typename T, int N>
__device__ __forceinline__ void load_widen(const T* p, float* out) {
  using V = typename RawVec<sizeof(T) * N>::type;
  const V raw = *reinterpret_cast<const V*>(p);
  T x[N];
  memcpy(x, &raw, sizeof(raw));
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = to_float(x[e]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

constexpr float kLog2e = 1.4426950408889634f;

}  // namespace repro_torch

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
