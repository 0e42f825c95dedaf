// K3 conv3x3_u8_bias_prelu: SAME 3x3 conv of the u8 frames, NHWC x HWIO ->
// NHWC, float32 accumulation, + bias (float32), cast to the compute dtype,
// PReLU in the compute dtype.  K4a conv3x3_u8_bias_prelu_q8 is K3 with an
// s8 output: the PReLU result is quantized in the epilogue,
// clip(round(float32(h) * inv), -127, 127), inv = 1 / act_scale[0].
//
// Replaces (TPU side): the XLA-fused conv graph of
//   K3  the u8 -> float32 * (1/255) -> compute-dtype cast of the engine
//       (reve_tpu/pipeline/engine.py:645, srvgg.py:154) fused with the first
//       3->64 conv + PReLU (srvgg.py:203-204).
//   K4a the int8 path's first conv + PReLU + _quant_s8 (srvgg.py:376-379).
// (K1, the hidden 64->64 conv, runs on the tensor cores: conv3x3_tc.cu in
// bfloat16, conv3x3_f32_tc.cu in float32.)
//
// Bound on an H100 SXM (3.35 TB/s), per 1080p frame: K3 7.2 GFLOP, 6 MB
// in + 265 MB out -> 0.08 ms (bytes); K4a writes s8, 6 MB in + 133 MB out
// -> 0.04 ms per frame (bytes).
//
// Design (a first, simple form): a direct conv on CUDA cores with fmaf,
// never TF32, so float32 matches the JAX reference's Precision.HIGHEST.
// Each block is persistent: it converts the 9*3*64 weights to float32 in
// shared memory once, then walks output tiles of TH x 32 pixels.  A tile
// plus its 1-pixel halo is staged in shared memory in the compute dtype
// (the cast of the u8 input happens there).  Each thread owns 4 pixels x
// 16 output channels (64 float32 accumulators).
#include <type_traits>

#include "common.cuh"

namespace {

using reve::from_float;
using reve::round_to;
using reve::to_float;

constexpr int COUT = 64;
constexpr int TW = 32;   // tile width in pixels
constexpr int PIX = 4;   // pixels per thread: columns pl, pl+8, pl+16, pl+24
constexpr int CPT = 16;  // output channels per thread
constexpr int CIN = 3;   // the u8 frames' channels

template <typename T, int TH>
struct Conv {
  static constexpr int SP = CIN;  // shared-memory pixel stride
  static constexpr int THREADS = TH * 32;
  static constexpr int W_FLOATS = 9 * CIN * COUT;
  static constexpr size_t SMEM = (size_t)(W_FLOATS + 2 * COUT) * sizeof(float)
                                 + (size_t)(TH + 2) * (TW + 2) * SP * sizeof(T);
};

// TOut is T, or int8_t for K4a (then `inv` points at 1 / act_scale[0])
template <typename T, typename TOut, int TH>
__global__ void __launch_bounds__(TH * 32, 1)
conv3x3_u8_bias_prelu_kernel(const uint8_t* __restrict__ x,
                             const T* __restrict__ w,
                             const float* __restrict__ bias,
                             const float* __restrict__ alpha,
                             const float* __restrict__ inv,
                             TOut* __restrict__ y, int B, int H, int W) {
  constexpr bool Q8 = std::is_same<TOut, int8_t>::value;
  using C = Conv<T, TH>;
  constexpr int SP = C::SP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // [9][CIN][COUT]
  float* bs = ws + C::W_FLOATS;                // [COUT]
  float* as = bs + COUT;                       // [COUT], alpha in dtype
  T* xs = reinterpret_cast<T*>(as + COUT);     // [(TH+2)*(TW+2)][SP]

  const int tid = threadIdx.x;
  for (int i = tid; i < C::W_FLOATS; i += C::THREADS) ws[i] = to_float(w[i]);
  for (int i = tid; i < COUT; i += C::THREADS) {
    bs[i] = bias[i];
    as[i] = alpha[i];
  }
  const float inv_s = Q8 ? *inv : 0.f;

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const long long ntiles = (long long)B * tiles_y * tiles_x;
  const int cg = tid & 3;           // output-channel group of 16
  const int pl = (tid & 31) >> 2;   // first of this thread's 4 columns
  const int row = tid >> 5;         // tile row

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = (int)(tile / ((long long)tiles_y * tiles_x));
    const int rem = (int)(tile - (long long)b * tiles_y * tiles_x);
    const int y0 = (rem / tiles_x) * TH;
    const int x0 = (rem % tiles_x) * TW;

    __syncthreads();  // the previous tile's reads of xs are done
    // u8 input: x = dtype(float32(u8) * float32(1/255)); zero padding
    constexpr int NE = (TH + 2) * (TW + 2) * CIN;
    for (int i = tid; i < NE; i += C::THREADS) {
      const int pix = i / CIN, ch = i - pix * CIN;
      const int r = pix / (TW + 2), c = pix - r * (TW + 2);
      const int gy = y0 - 1 + r, gx = x0 - 1 + c;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = reve::u8_to_unit(
            x[(((long long)b * H + gy) * W + gx) * CIN + ch]);
      xs[pix * SP + ch] = from_float<T>(v);
    }
    __syncthreads();

    float acc[PIX][CPT];
#pragma unroll
    for (int k = 0; k < PIX; ++k)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[k][j] = 0.f;

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
      const T* xr = xs + ((row + dy) * (TW + 2) + pl + dx) * SP;
      const float4* wr =
          reinterpret_cast<const float4*>(ws + tap * CIN * COUT + cg * CPT);
#pragma unroll 4
      for (int ci = 0; ci < CIN; ++ci) {
        float xv[PIX];
#pragma unroll
        for (int k = 0; k < PIX; ++k) xv[k] = to_float(xr[k * 8 * SP + ci]);
#pragma unroll
        for (int q = 0; q < CPT / 4; ++q) {
          const float4 wv = wr[ci * (COUT / 4) + q];
#pragma unroll
          for (int k = 0; k < PIX; ++k) {
            acc[k][4 * q + 0] = fmaf(xv[k], wv.x, acc[k][4 * q + 0]);
            acc[k][4 * q + 1] = fmaf(xv[k], wv.y, acc[k][4 * q + 1]);
            acc[k][4 * q + 2] = fmaf(xv[k], wv.z, acc[k][4 * q + 2]);
            acc[k][4 * q + 3] = fmaf(xv[k], wv.w, acc[k][4 * q + 3]);
          }
        }
      }
    }

    const int oy = y0 + row;
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const int ox = x0 + pl + 8 * k;
      if (oy >= H || ox >= W) continue;
      __align__(16) TOut outv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = cg * CPT + j;
        // (acc + b) in float32, cast to dtype; PReLU in dtype:
        // max(v, 0) + dtype(alpha * min(v, 0))
        const float v = round_to<T>(__fadd_rn(acc[k][j], bs[c]));
        const T h = v > 0.f ? from_float<T>(v)
                            : from_float<T>(__fmul_rn(as[c], v));
        if constexpr (Q8)
          outv[j] = reve::quant_s8(to_float(h), inv_s);
        else
          outv[j] = h;
      }
      uint4* dst = reinterpret_cast<uint4*>(
          y + (((long long)b * H + oy) * W + ox) * COUT + cg * CPT);
      const uint4* src = reinterpret_cast<const uint4*>(outv);
#pragma unroll
      for (int q = 0; q < (int)(CPT * sizeof(TOut) / 16); ++q) dst[q] = src[q];
    }
  }
}

template <typename T, int TH, typename TOut = T>
cudaError_t launch(const void* x, const void* w, const float* b,
                   const float* a, void* y, int B, int H, int W,
                   cudaStream_t stream, const float* inv = nullptr) {
  using C = Conv<T, TH>;
  auto kernel = conv3x3_u8_bias_prelu_kernel<T, TOut, TH>;
  const long long tiles =
      (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  int grid = 0;
  cudaError_t err =
      reve::persistent_grid(kernel, C::THREADS, C::SMEM, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const T*>(w), b, a, inv,
      static_cast<TOut*>(y), B, H, W);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
extern "C" int reve_conv3x3_u8_bias_prelu(const void* x, const void* w,
                                          const float* b, const float* alpha,
                                          void* y, int B, int H, int W,
                                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, 8>(x, w, b, alpha, y, B, H, W, s);
  if (dtype == 0)
    return launch<float, 8>(x, w, b, alpha, y, B, H, W, s);
  return (int)cudaErrorInvalidValue;
}

// K4a: K3 with the s8 quantize epilogue; `inv` is a device pointer to
// float32(1 / act_scale[0]).
extern "C" int reve_conv3x3_u8_bias_prelu_q8(const void* x, const void* w,
                                             const float* b,
                                             const float* alpha,
                                             const float* inv, void* y, int B,
                                             int H, int W, int dtype,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, 8, int8_t>(x, w, b, alpha, y, B, H, W, s,
                                            inv);
  if (dtype == 0)
    return launch<float, 8, int8_t>(x, w, b, alpha, y, B, H, W, s, inv);
  return (int)cudaErrorInvalidValue;
}
