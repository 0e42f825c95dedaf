// K2 head_conv_residual_u8_shuffle: the SRVGG head conv 64 -> 3r^2 fused
// with the whole u8 epilogue, NHWC:
//   h   = dtype(conv3x3(x, w) + b)              (float32 acc, + b in float32)
//   y   = float32(h) + repeat(u8 * (1/255), r^2) (float32 residual)
//   out = u8(clip(y * 255 + 0.5, 0, 255))       (truncating cast)
// stored straight to (B, H*r, W*r, 3) in torch's pixel-shuffle order
// (channel c*r^2 + i*r + j -> output pixel (h*r + i, w*r + j), channel c).
//
// Replaces (TPU side): reve_tpu/models/srvgg.py:211-212 (head _conv3x3)
// with _epilogue(quantize_u8=True) (srvgg.py:239-262) and
// reve_tpu/ops/pixel_shuffle.py:pixel_shuffle (pixel_shuffle.py:14-22),
// which XLA fused into the conv graph.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor, 3.35 TB/s), per 1080p
// frame at r=4: 114.7 GFLOP -> 0.116 ms; 265 MB in + 6 MB u8 in + 99.5 MB
// u8 out (7680x4320x3) -> 0.111 ms; so about 0.116 ms (operations).
//
// Design (a first, simple form): a direct conv on CUDA cores with fmaf
// (never TF32); persistent blocks hold the 9x64x(3r^2, padded to a multiple
// of 4) float32 weights in dynamic shared memory (111 KB at r=4) and walk
// 4 x 64 pixel tiles staged with their halo in shared memory.  Each thread
// owns 2 pixels x all 3r^2 channels, so the residual, rounding and shuffle
// all happen in registers and the only global write is the u8 output: no
// float32 head tensor, no separate shuffle pass.  Every rounding point is
// an explicit __f*_rn so the compiler cannot contract it into an FMA that
// the JAX graph does not have.
#include "common.cuh"

namespace {

using reve::round_to;
using reve::to_float;

constexpr int CIN = 64;
constexpr int TH = 4;
constexpr int TW = 64;
constexpr int PIX = 2;  // columns col and col + 32
constexpr int THREADS = TH * 32;

template <typename T, int R>
struct Head {
  static constexpr int COUT = 3 * R * R;
  static constexpr int COUTP = (COUT + 3) / 4 * 4;
  static constexpr int SP = sizeof(T) == 2 ? 66 : 65;
  static constexpr int W_FLOATS = 9 * CIN * COUTP;
  static constexpr size_t SMEM = (size_t)(W_FLOATS + COUTP) * sizeof(float)
                                 + (size_t)(TH + 2) * (TW + 2) * SP * sizeof(T);
};

template <typename T, int R>
__global__ void __launch_bounds__(THREADS, 1)
head_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const float* __restrict__ bias, const uint8_t* __restrict__ orig,
            uint8_t* __restrict__ out, int B, int H, int W) {
  using C = Head<T, R>;
  constexpr int COUT = C::COUT, COUTP = C::COUTP, SP = C::SP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // [9][CIN][COUTP]
  float* bs = ws + C::W_FLOATS;                // [COUTP]
  T* xs = reinterpret_cast<T*>(bs + COUTP);    // [(TH+2)*(TW+2)][SP]

  const int tid = threadIdx.x;
  for (int i = tid; i < C::W_FLOATS; i += THREADS) {
    const int tc = i / COUTP, co = i - tc * COUTP;
    ws[i] = co < COUT ? to_float(w[tc * COUT + co]) : 0.f;
  }
  for (int i = tid; i < COUTP; i += THREADS) bs[i] = i < COUT ? bias[i] : 0.f;

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const long long ntiles = (long long)B * tiles_y * tiles_x;
  const int col = tid & 31;
  const int row = tid >> 5;
  const long long out_w = (long long)W * R;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = (int)(tile / ((long long)tiles_y * tiles_x));
    const int rem = (int)(tile - (long long)b * tiles_y * tiles_x);
    const int y0 = (rem / tiles_x) * TH;
    const int x0 = (rem % tiles_x) * TW;

    __syncthreads();
    constexpr int EPV = 16 / sizeof(T);
    constexpr int VPP = CIN / EPV;
    constexpr int NV = (TH + 2) * (TW + 2) * VPP;
    for (int i = tid; i < NV; i += THREADS) {
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
    __syncthreads();

    float acc[PIX][COUTP];
#pragma unroll
    for (int k = 0; k < PIX; ++k)
#pragma unroll
      for (int j = 0; j < COUTP; ++j) acc[k][j] = 0.f;

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
      const T* xr = xs + ((row + dy) * (TW + 2) + col + dx) * SP;
      const float4* wr =
          reinterpret_cast<const float4*>(ws + tap * CIN * COUTP);
#pragma unroll 2
      for (int ci = 0; ci < CIN; ++ci) {
        float xv[PIX];
#pragma unroll
        for (int k = 0; k < PIX; ++k) xv[k] = to_float(xr[k * 32 * SP + ci]);
#pragma unroll
        for (int q = 0; q < COUTP / 4; ++q) {
          const float4 wv = wr[ci * (COUTP / 4) + q];
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
      const int ox = x0 + col + 32 * k;
      if (oy >= H || ox >= W) continue;
      const uint8_t* o = orig + (((long long)b * H + oy) * W + ox) * 3;
      const float base[3] = {reve::u8_to_unit(o[0]), reve::u8_to_unit(o[1]),
                             reve::u8_to_unit(o[2])};
#pragma unroll
      for (int kk = 0; kk < COUT; ++kk) {
        const int c = kk / (R * R), i = (kk / R) % R, j = kk % R;
        const float hv = round_to<T>(__fadd_rn(acc[k][kk], bs[kk]));
        const float yv = __fadd_rn(hv, base[c]);
        float q = __fadd_rn(__fmul_rn(yv, 255.f), 0.5f);
        q = fminf(fmaxf(q, 0.f), 255.f);
        out[(((long long)b * H + oy) * R + i) * out_w * 3 +
            ((long long)ox * R + j) * 3 + c] = (uint8_t)q;
      }
    }
  }
}

template <typename T, int R>
cudaError_t launch(const void* x, const void* w, const float* b,
                   const uint8_t* orig, uint8_t* out, int B, int H, int W,
                   cudaStream_t stream) {
  using C = Head<T, R>;
  auto kernel = head_kernel<T, R>;
  const long long tiles =
      (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  int grid = 0;
  cudaError_t err =
      reve::persistent_grid(kernel, THREADS, C::SMEM, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, C::SMEM, stream>>>(static_cast<const T*>(x),
                                             static_cast<const T*>(w), b,
                                             orig, out, B, H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_r(int r, const void* x, const void* w, const float* b,
                     const uint8_t* orig, uint8_t* out, int B, int H, int W,
                     cudaStream_t s) {
  switch (r) {
    case 2: return launch<T, 2>(x, w, b, orig, out, B, H, W, s);
    case 3: return launch<T, 3>(x, w, b, orig, out, B, H, W, s);
    case 4: return launch<T, 4>(x, w, b, orig, out, B, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; r in {2, 3, 4}.  Returns a cudaError_t.
extern "C" int reve_head_conv_residual_u8_shuffle(
    const void* x, const void* w, const float* b, const uint8_t* orig,
    uint8_t* out, int B, int H, int W, int r, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_r<__nv_bfloat16>(r, x, w, b, orig, out, B, H, W, s);
  if (dtype == 0) return (int)launch_r<float>(r, x, w, b, orig, out, B, H, W, s);
  return (int)cudaErrorInvalidValue;
}
