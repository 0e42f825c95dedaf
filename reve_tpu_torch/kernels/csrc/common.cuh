// Shared helpers for the SRVGG conv kernels (sm_90a, plain C interface).
//
// Every kernel accumulates in float32 with fmaf (never TF32), and rounds
// to the storage type exactly where reve_tpu/models/srvgg.py rounds: the
// conv output (acc + bias, float32) is cast to the compute dtype, PReLU
// runs in the compute dtype, and the residual epilogue runs in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace reve {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(uint8_t v) { return (float)v; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// float32(1.0 / 255.0): the constant the JAX engine multiplies u8 by
// (a Python double rounded once to float32).
__device__ __forceinline__ float u8_to_unit(uint8_t v) {
  return __fmul_rn((float)v, (float)(1.0 / 255.0));
}

// Round v to T and back: the value a cast to the compute dtype leaves.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// Launch grid for a persistent kernel: one wave of resident blocks (each
// loads its weights into shared memory once and then walks many tiles).
template <typename K>
inline cudaError_t persistent_grid(K kernel, int threads, size_t smem,
                                   long long tiles, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long g = (long long)sms * per_sm;
  *grid = (int)(tiles < g ? tiles : g);
  return cudaSuccess;
}

}  // namespace reve

// Message for a cudaError_t returned by one of the library's launch entry
// points (each source is its own shared library, so each defines it once).
extern "C" const char* reve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
