// Building blocks shared by the CUDA-core (SIMT) attention kernels, the
// forward (flash_attention.cu) and its backward (flash_attention_bwd.cu):
// fp32 or bf16 inputs loaded as fp32, fp32 results stored in the inputs'
// type, and the width of their staged fp32 rows.  Every function is
// internal to the including file (an anonymous namespace), so each
// translation unit keeps its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_HEAD = 256;   // the largest D and Dv
constexpr unsigned FULL = 0xffffffffu;

// floats of a staged row of `w` columns: w rounded up to 4, then to an odd
// number of float4s (conflict-free float4 reads of eight rows at a column)
__host__ __device__ constexpr int row_ld(int w) {
  return 4 * (((w + 3) / 4) | 1);
}

// an input element as fp32, and an fp32 result stored in the inputs' type
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// four input elements at p (16-byte aligned fp32, 8-byte aligned bf16) as
// fp32
__device__ __forceinline__ float4 ld_vec4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld_vec4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// four floats of a staged tile in shared memory
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// whether rows `stride` elements apart from src, w wide, can be read four
// elements at a time
template <class T>
__device__ __forceinline__ bool vec_rows(const T* src, size_t stride,
                                         int w) {
  return w % 4 == 0 && stride % 4 == 0 &&
         reinterpret_cast<uintptr_t>(src) % (4 * sizeof(T)) == 0;
}

}  // namespace
