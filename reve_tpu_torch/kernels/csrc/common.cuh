// Shared helpers for the SRVGG conv kernels (sm_90a, plain C interface).
//
// Every float kernel accumulates in float32 (fmaf on CUDA cores, or the
// tensor cores' float32 accumulators for bf16 operands, float32 values as
// three bf16 parts; never TF32), every s8 kernel exactly in s32, and rounds
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

// The head's float32 residual + u8 rounding of one output channel:
// u8(clip((h + base) * 255 + 0.5, 0, 255)), each step rounded on its own;
// the clip and the truncating cast as one saturating conversion (NaN
// gives 0, as the clip does).
__device__ __forceinline__ uint8_t residual_u8(float hv, float base) {
  const float yv = __fadd_rn(hv, base);
  const float q = __fadd_rn(__fmul_rn(yv, 255.f), 0.5f);
  unsigned short r;
  asm("cvt.rzi.sat.u8.f32 %0, %1;" : "=h"(r) : "f"(q));
  return (uint8_t)r;
}

// Round v to T and back: the value a cast to the compute dtype leaves.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// reve_tpu srvgg._quant_s8: round(x * (1/scale)) half to even, clipped to
// +-127, as the s8 code's byte.  `inv` is float32(1/scale), formed by the
// wrapper in torch exactly as the reference forms it.  One saturating
// conversion: clip(rint(v), -127, 127) == rint(max(v, -127)) saturated to
// s8 (rint is monotone and +-127 are integers); cvt.rni rounds half to
// even, as rintf does (roundf would take halves away from zero).
__device__ __forceinline__ uint32_t quant_s8(float x, float inv) {
  unsigned short r;
  asm("cvt.rni.sat.s8.f32 %0, %1;"
      : "=h"(r)
      : "f"(fmaxf(__fmul_rn(x, inv), -127.f)));
  return r & 0xFFu;
}

// quant_s8's code of x * inv, in float32 arithmetic only, as the low byte
// of the result.  Clip first (+-127 are integers: clip(rint(v)) ==
// rint(clip(v))), then add 1.5 * 2^23, where the float32 spacing is 1:
// the sum rounds to the nearest integer, ties to even, and its low byte is
// the code in two's complement.  The same bits as quant_s8, whose
// conversion instruction issues at a quarter of the float32 rate on
// Hopper: K4a and the wide K4 have one a value.
__device__ __forceinline__ uint32_t quant_bits(float x, float inv) {
  const float v = fminf(fmaxf(__fmul_rn(x, inv), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(v, 12582912.f));
}

// Launch grid for a persistent kernel: one wave of resident blocks (each
// loads its weights into shared memory once and then walks many tiles),
// at most `max_per_sm` on each SM.
template <typename K>
inline cudaError_t persistent_grid(K kernel, int threads, size_t smem,
                                   long long tiles, int* grid,
                                   int max_per_sm = 1 << 30) {
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
  long long g = (long long)sms * (per_sm < max_per_sm ? per_sm : max_per_sm);
  *grid = (int)(tiles < g ? tiles : g);
  return cudaSuccess;
}

}  // namespace reve

// Message for a cudaError_t returned by one of the library's launch entry
// points (each source is its own shared library, so each defines it once).
extern "C" const char* reve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
