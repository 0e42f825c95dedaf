// K4 conv3x3_s8_dq_prelu_q8: one hidden layer of the int8 SRVGG body, NHWC:
//   acc = conv3x3(x8, w8)                      s8 x s8 -> s32, SAME zero pad
//   fy  = float32(acc) * scale[c] + b[c]       scale = act_scale[i] * sw[i]
//   p   = max(fy, 0) + alpha[c] * min(fy, 0)   PReLU in float32, float32 alpha
//   y8  = clip(round(p * inv), -127, 127)      inv = 1 / act_scale[i + 1]
//
// Replaces (TPU side): reve_tpu/models/srvgg.py:380-382, the classic-domain
// loop of apply_int8 (_conv3x3_s8 :268-276, dq_prelu :322-329, _quant_s8
// :279-288), which XLA fused into one s8 conv with its epilogue.
//
// Bound on an H100 SXM per call at the main path's batch of 4 1920x1080
// frames: 611.5 GOP / 1979 TOP/s (s8 tensor, dense) = 0.31 ms; 531 MB of s8
// in + 531 MB out = 1.06 GB / 3.35 TB/s = 0.32 ms, so bytes by a hair.
//
// Design (a first, simple form): a direct conv on CUDA cores with __dp4a
// (4 s8 products summed into s32 per instruction), not the tensor cores:
// exact integer accumulation, so the kernel is bit-exact against its plain
// version; wgmma is later work.  Each block is persistent: it repacks the
// 9x64x64 s8 HWIO weights into dp4a words [tap][ci/4][co] in shared memory
// (36.9 KB) once, then walks 8 x 32 pixel tiles staged with their halo as
// 16 words per pixel at an odd word stride (17), so the 8 pixels a warp reads
// at once hit distinct banks.  Each thread owns 4 pixels x 16 output channels
// (64 s32 accumulators) and writes its 16 s8 outputs as one 16-byte store.
// The epilogue rounds exactly where the reference does: __fmul_rn/__fadd_rn
// keep nvcc from contracting the dequant into an FMA, rintf rounds half to
// even.
#include "common.cuh"

namespace {

constexpr int C = 64;        // channels in and out
constexpr int CW = C / 4;    // dp4a words per pixel
constexpr int TW = 32;       // tile width in pixels
constexpr int TH = 8;        // tile height in pixels (one warp per row)
constexpr int THREADS = TH * 32;
constexpr int PIX = 4;       // pixels per thread: columns pl, pl+8, pl+16, pl+24
constexpr int CPT = 16;      // output channels per thread
constexpr int SPW = CW + 1;  // shared-memory pixel stride in words (odd)
constexpr int W_WORDS = 9 * CW * C;
constexpr size_t SMEM = (size_t)W_WORDS * 4 + 3 * C * sizeof(float) +
                        (size_t)(TH + 2) * (TW + 2) * SPW * 4;

__global__ void __launch_bounds__(THREADS)
conv3x3_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias,
                  const float* __restrict__ alpha,
                  const float* __restrict__ inv_next, int8_t* __restrict__ y,
                  int B, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* ws = reinterpret_cast<int*>(smem);                // [9][CW][C]
  float* ss = reinterpret_cast<float*>(ws + W_WORDS);    // [C]
  float* bs = ss + C;                                    // [C]
  float* as = bs + C;                                    // [C]
  int* xs = reinterpret_cast<int*>(as + C);              // [pix][SPW]

  const int tid = threadIdx.x;
  for (int i = tid; i < W_WORDS; i += THREADS) {
    const int co = i % C, ciw = (i / C) % CW, tap = i / (C * CW);
    ws[i] = reve::pack_s8x4(w + ((size_t)tap * C + ciw * 4) * C + co, C);
  }
  for (int i = tid; i < C; i += THREADS) {
    ss[i] = scale[i];
    bs[i] = bias[i];
    as[i] = alpha[i];
  }
  const float inv = *inv_next;

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const long long ntiles = (long long)B * tiles_y * tiles_x;
  const int cg = tid & 3;          // output-channel group of 16
  const int pl = (tid & 31) >> 2;  // first of this thread's 4 columns
  const int row = tid >> 5;        // tile row

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = (int)(tile / ((long long)tiles_y * tiles_x));
    const int rem = (int)(tile - (long long)b * tiles_y * tiles_x);
    const int y0 = (rem / tiles_x) * TH;
    const int x0 = (rem % tiles_x) * TW;

    __syncthreads();  // the previous tile's reads of xs are done
    constexpr int VPP = C / 16;  // 16-byte vectors per pixel
    constexpr int NV = (TH + 2) * (TW + 2) * VPP;
    for (int i = tid; i < NV; i += THREADS) {
      const int pix = i / VPP, v = i - pix * VPP;
      const int r = pix / (TW + 2), c = pix - r * (TW + 2);
      const int gy = y0 - 1 + r, gx = x0 - 1 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        val = __ldg(reinterpret_cast<const uint4*>(
                        x + (((long long)b * H + gy) * W + gx) * C) + v);
      int* dst = xs + pix * SPW + v * 4;
      dst[0] = (int)val.x;
      dst[1] = (int)val.y;
      dst[2] = (int)val.z;
      dst[3] = (int)val.w;
    }
    __syncthreads();

    int acc[PIX][CPT];
#pragma unroll
    for (int k = 0; k < PIX; ++k)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[k][j] = 0;

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
      const int* xr = xs + ((row + dy) * (TW + 2) + pl + dx) * SPW;
      const int4* wr =
          reinterpret_cast<const int4*>(ws + tap * CW * C + cg * CPT);
#pragma unroll 4
      for (int ciw = 0; ciw < CW; ++ciw) {
        int xv[PIX];
#pragma unroll
        for (int k = 0; k < PIX; ++k) xv[k] = xr[k * 8 * SPW + ciw];
#pragma unroll
        for (int q = 0; q < CPT / 4; ++q) {
          const int4 wv = wr[ciw * (C / 4) + q];
#pragma unroll
          for (int k = 0; k < PIX; ++k) {
            acc[k][4 * q + 0] = __dp4a(xv[k], wv.x, acc[k][4 * q + 0]);
            acc[k][4 * q + 1] = __dp4a(xv[k], wv.y, acc[k][4 * q + 1]);
            acc[k][4 * q + 2] = __dp4a(xv[k], wv.z, acc[k][4 * q + 2]);
            acc[k][4 * q + 3] = __dp4a(xv[k], wv.w, acc[k][4 * q + 3]);
          }
        }
      }
    }

    const int oy = y0 + row;
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const int ox = x0 + pl + 8 * k;
      if (oy >= H || ox >= W) continue;
      uint32_t packed[CPT / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = cg * CPT + j;
        // |acc| <= 9*64*127^2 < 2^24: the float32 conversion is exact
        const float fy = __fadd_rn(__fmul_rn((float)acc[k][j], ss[c]), bs[c]);
        const float p = fy > 0.f ? fy : __fmul_rn(as[c], fy);
        packed[j / 4] |= (uint32_t)(uint8_t)reve::quant_s8(p, inv)
                         << (8 * (j % 4));
      }
      *reinterpret_cast<uint4*>(
          y + (((long long)b * H + oy) * W + ox) * C + cg * CPT) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
}

}  // namespace

// Returns a cudaError_t (0 = success).
extern "C" int reve_conv3x3_s8_dq_prelu_q8(const void* x, const void* w,
                                           const float* scale,
                                           const float* bias,
                                           const float* alpha,
                                           const float* inv_next, void* y,
                                           int B, int H, int W,
                                           void* stream) {
  const long long tiles =
      (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return (int)cudaSuccess;
  int grid = 0;
  cudaError_t err =
      reve::persistent_grid(conv3x3_s8_kernel, THREADS, SMEM, tiles, &grid);
  if (err != cudaSuccess) return (int)err;
  conv3x3_s8_kernel<<<grid, THREADS, SMEM,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), scale,
      bias, alpha, inv_next, static_cast<int8_t*>(y), B, H, W);
  return (int)cudaGetLastError();
}
