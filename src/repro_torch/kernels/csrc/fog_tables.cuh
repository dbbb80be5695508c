// Packed grove-table values -> the fp32 values every kernel compares and
// sums, applied after the gather (shared by fog_kernels.cu and
// tree_traverse.cu).  fp32 passes through, bf16 upcasts exactly, int8
// multiplies by the tree's scale with an explicitly rounded product; in
// thresholds the int8 codes ±127 stand for ±inf (the "always go left"
// padding nodes).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace fog {

struct TabF32 {
  typedef float T;
  static __device__ __forceinline__ float thr(T q, float) { return q; }
  static __device__ __forceinline__ float leaf(T q, float) { return q; }
};

struct TabBF16 {
  typedef uint16_t T;  // raw bfloat16 bits
  static __device__ __forceinline__ float up(T q) {
    return __uint_as_float((uint32_t)q << 16);
  }
  static __device__ __forceinline__ float thr(T q, float) { return up(q); }
  static __device__ __forceinline__ float leaf(T q, float) { return up(q); }
};

struct TabI8 {
  typedef int8_t T;
  static __device__ __forceinline__ float thr(T q, float s) {
    if (q == 127) return CUDART_INF_F;
    if (q == -127) return -CUDART_INF_F;
    return __fmul_rn((float)q, s);
  }
  static __device__ __forceinline__ float leaf(T q, float s) {
    return __fmul_rn((float)q, s);
  }
};

}  // namespace fog
