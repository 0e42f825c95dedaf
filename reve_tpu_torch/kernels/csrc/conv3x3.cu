// K1 conv3x3_bias_prelu and K3 conv3x3_u8_bias_prelu: SAME 3x3 conv,
// NHWC x HWIO -> NHWC, float32 accumulation, + bias (float32), cast to the
// compute dtype, PReLU in the compute dtype.
//
// Replaces (TPU side): the XLA-fused conv graph of
//   K1  reve_tpu/models/srvgg.py:_conv3x3 + _prelu (srvgg.py:88-113), the
//       16 hidden 64->64 layers of apply (srvgg.py:205-210);
//   K3  the u8 -> float32 * (1/255) -> compute-dtype cast of the engine
//       (reve_tpu/pipeline/engine.py:645, srvgg.py:154) fused with the first
//       3->64 conv + PReLU (srvgg.py:203-204).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor, 3.35 TB/s), per 1080p
// frame: K1 152.9 GFLOP -> 0.155 ms, 531 MB of bf16 in + out -> 0.158 ms;
// K3 7.2 GFLOP, 6 MB in + 265 MB out -> 0.08 ms (bytes).
//
// Design (a first, simple form): a direct conv on CUDA cores with fmaf,
// never TF32, so float32 matches the JAX reference's Precision.HIGHEST.
// Its own ceiling is the ~67 TFLOP/s float32 FMA rate, not the tensor
// cores; wgmma/TMA is later work.  Each block is persistent: it converts
// the 9*Cin*64 weights to float32 in dynamic shared memory once (147 KB
// for 64->64), then walks output tiles of TH x 32 pixels.  A tile plus its
// 1-pixel halo is staged in shared memory in the compute dtype (the cast
// of K3's u8 input happens there), with an odd per-pixel word stride so
// the 8 pixels a warp reads at once hit distinct banks.  Each thread owns
// 4 pixels x 16 output channels (64 float32 accumulators).
#include "common.cuh"

namespace {

using reve::from_float;
using reve::round_to;
using reve::to_float;

constexpr int COUT = 64;
constexpr int TW = 32;   // tile width in pixels
constexpr int PIX = 4;   // pixels per thread: columns pl, pl+8, pl+16, pl+24
constexpr int CPT = 16;  // output channels per thread

template <typename TIn, typename T, int CIN, int TH>
struct Conv {
  // shared-memory pixel stride in elements of T: odd in 32-bit words
  static constexpr int SP = CIN == 64 ? (sizeof(T) == 2 ? 66 : 65) : CIN;
  static constexpr int THREADS = TH * 32;
  static constexpr int W_FLOATS = 9 * CIN * COUT;
  static constexpr size_t SMEM = (size_t)(W_FLOATS + 2 * COUT) * sizeof(float)
                                 + (size_t)(TH + 2) * (TW + 2) * SP * sizeof(T);
};

template <typename TIn, typename T, int CIN, int TH>
__global__ void __launch_bounds__(TH * 32, 1)
conv3x3_bias_prelu_kernel(const TIn* __restrict__ x, const T* __restrict__ w,
                          const float* __restrict__ bias,
                          const float* __restrict__ alpha, T* __restrict__ y,
                          int B, int H, int W) {
  using C = Conv<TIn, T, CIN, TH>;
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
    if constexpr (CIN == 64) {
      constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte vector
      constexpr int VPP = CIN / EPV;       // vectors per pixel
      constexpr int NV = (TH + 2) * (TW + 2) * VPP;
      for (int i = tid; i < NV; i += C::THREADS) {
        const int pix = i / VPP, v = i - pix * VPP;
        const int r = pix / (TW + 2), c = pix - r * (TW + 2);
        const int gy = y0 - 1 + r, gx = x0 - 1 + c;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (gy >= 0 && gy < H && gx >= 0 && gx < W)
          val = __ldg(reinterpret_cast<const uint4*>(
                          x + (((long long)b * H + gy) * W + gx) * CIN) + v);
        uint32_t* dst = reinterpret_cast<uint32_t*>(xs + pix * SP + v * EPV);
        dst[0] = val.x;
        dst[1] = val.y;
        dst[2] = val.z;
        dst[3] = val.w;
      }
    } else {
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
      __align__(16) T outv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = cg * CPT + j;
        // (acc + b) in float32, cast to dtype; PReLU in dtype:
        // max(v, 0) + dtype(alpha * min(v, 0))
        const float v = round_to<T>(__fadd_rn(acc[k][j], bs[c]));
        outv[j] = v > 0.f ? from_float<T>(v)
                          : from_float<T>(__fmul_rn(as[c], v));
      }
      uint4* dst = reinterpret_cast<uint4*>(
          y + (((long long)b * H + oy) * W + ox) * COUT + cg * CPT);
      const uint4* src = reinterpret_cast<const uint4*>(outv);
#pragma unroll
      for (int q = 0; q < (int)(CPT * sizeof(T) / 16); ++q) dst[q] = src[q];
    }
  }
}

template <typename TIn, typename T, int CIN, int TH>
cudaError_t launch(const void* x, const void* w, const float* b,
                   const float* a, void* y, int B, int H, int W,
                   cudaStream_t stream) {
  using C = Conv<TIn, T, CIN, TH>;
  auto kernel = conv3x3_bias_prelu_kernel<TIn, T, CIN, TH>;
  const long long tiles =
      (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  int grid = 0;
  cudaError_t err =
      reve::persistent_grid(kernel, C::THREADS, C::SMEM, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const TIn*>(x), static_cast<const T*>(w), b, a,
      static_cast<T*>(y), B, H, W);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
extern "C" int reve_conv3x3_bias_prelu(const void* x, const void* w,
                                       const float* b, const float* alpha,
                                       void* y, int B, int H, int W,
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, 64, 8>(x, w, b, alpha, y, B,
                                                       H, W, s);
  if (dtype == 0)
    return launch<float, float, 64, 4>(x, w, b, alpha, y, B, H, W, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int reve_conv3x3_u8_bias_prelu(const void* x, const void* w,
                                          const float* b, const float* alpha,
                                          void* y, int B, int H, int W,
                                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<uint8_t, __nv_bfloat16, 3, 8>(x, w, b, alpha, y, B, H, W,
                                                s);
  if (dtype == 0)
    return launch<uint8_t, float, 3, 8>(x, w, b, alpha, y, B, H, W, s);
  return (int)cudaErrorInvalidValue;
}
