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
// Design (a first, simple form; float32 only, bfloat16 K2 runs on the
// tensor cores in conv3x3_tc.cu): a direct conv on CUDA cores with fmaf
// (never TF32); persistent blocks hold the 9x64x(3r^2, padded to a multiple
// of 4) float32 weights in dynamic shared memory (111 KB at r=4) and walk
// 4 x 64 pixel tiles staged with their halo in shared memory.  Each thread
// owns 2 pixels x all 3r^2 channels, so the residual, rounding and shuffle
// all happen in registers and the only global write is the u8 output: no
// float32 head tensor, no separate shuffle pass.  Every rounding point is
// an explicit __f*_rn so the compiler cannot contract it into an FMA that
// the JAX graph does not have.
//
// K4h head_conv_s8_residual_u8_shuffle is the int8 path's head, the same
// kernel shape on s8 input:
//   h   = float32(conv3x3(x8, w8)) * scale + b    (s32 acc, scale =
//                                                 act_scale[n] * sw_last;
//                                                 NO cast to the compute dtype)
//   then K2's residual, rounding and shuffle.
// Replaces reve_tpu/models/srvgg.py:383-386 (int8_head) with _epilogue
// (:251-262).  Bound at r=4 per call of 4 1080p frames: 458.6 GOP / 1979
// TOP/s = 0.23 ms; 531 MB s8 + 25 MB u8 in + 398 MB u8 out = 0.95 GB ->
// 0.29 ms (bytes).  Design: __dp4a on CUDA cores over dp4a words [tap][ci/4]
// [co] in shared memory, the halo tile at an odd word stride (17) per
// pixel; 2 pixels x all 3r^2 s32 accumulators per thread, then K2's
// register epilogue.
#include "common.cuh"

namespace {

using reve::residual_u8;

constexpr int CIN = 64;
constexpr int TH = 4;
constexpr int TW = 64;
constexpr int PIX = 2;  // columns col and col + 32
constexpr int THREADS = TH * 32;

template <int R>
struct Head {
  static constexpr int COUT = 3 * R * R;
  static constexpr int COUTP = (COUT + 3) / 4 * 4;
  static constexpr int SP = 65;  // pixel stride in floats: odd
  static constexpr int W_FLOATS = 9 * CIN * COUTP;
  static constexpr size_t SMEM =
      (size_t)(W_FLOATS + COUTP + (TH + 2) * (TW + 2) * SP) * sizeof(float);
};

template <int R>
__global__ void __launch_bounds__(THREADS, 1)
head_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, const uint8_t* __restrict__ orig,
            uint8_t* __restrict__ out, int B, int H, int W) {
  using C = Head<R>;
  constexpr int COUT = C::COUT, COUTP = C::COUTP, SP = C::SP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // [9][CIN][COUTP]
  float* bs = ws + C::W_FLOATS;                // [COUTP]
  float* xs = bs + COUTP;                      // [(TH+2)*(TW+2)][SP]

  const int tid = threadIdx.x;
  for (int i = tid; i < C::W_FLOATS; i += THREADS) {
    const int tc = i / COUTP, co = i - tc * COUTP;
    ws[i] = co < COUT ? w[tc * COUT + co] : 0.f;
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
    constexpr int VPP = CIN / 4;  // 16-byte vectors per pixel
    constexpr int NV = (TH + 2) * (TW + 2) * VPP;
    for (int i = tid; i < NV; i += THREADS) {
      const int pix = i / VPP, v = i - pix * VPP;
      const int r = pix / (TW + 2), c = pix - r * (TW + 2);
      const int gy = y0 - 1 + r, gx = x0 - 1 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        val = __ldg(reinterpret_cast<const uint4*>(
                        x + (((long long)b * H + gy) * W + gx) * CIN) + v);
      uint32_t* dst = reinterpret_cast<uint32_t*>(xs + pix * SP + v * 4);
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
      const float* xr = xs + ((row + dy) * (TW + 2) + col + dx) * SP;
      const float4* wr =
          reinterpret_cast<const float4*>(ws + tap * CIN * COUTP);
#pragma unroll 2
      for (int ci = 0; ci < CIN; ++ci) {
        float xv[PIX];
#pragma unroll
        for (int k = 0; k < PIX; ++k) xv[k] = xr[k * 32 * SP + ci];
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
        const float hv = __fadd_rn(acc[k][kk], bs[kk]);  // float32: no cast
        out[(((long long)b * H + oy) * R + i) * out_w * 3 +
            ((long long)ox * R + j) * 3 + c] = residual_u8(hv, base[c]);
      }
    }
  }
}

template <int R>
cudaError_t launch(const void* x, const void* w, const float* b,
                   const uint8_t* orig, uint8_t* out, int B, int H, int W,
                   cudaStream_t stream) {
  using C = Head<R>;
  auto kernel = head_kernel<R>;
  const long long tiles =
      (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  int grid = 0;
  cudaError_t err =
      reve::persistent_grid(kernel, THREADS, C::SMEM, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, C::SMEM, stream>>>(static_cast<const float*>(x),
                                             static_cast<const float*>(w), b,
                                             orig, out, B, H, W);
  return cudaGetLastError();
}

cudaError_t launch_r(int r, const void* x, const void* w, const float* b,
                     const uint8_t* orig, uint8_t* out, int B, int H, int W,
                     cudaStream_t s) {
  switch (r) {
    case 2: return launch<2>(x, w, b, orig, out, B, H, W, s);
    case 3: return launch<3>(x, w, b, orig, out, B, H, W, s);
    case 4: return launch<4>(x, w, b, orig, out, B, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- K4h: the same head on s8 input, dequantized in float32 -----------------

constexpr int CW = CIN / 4;    // dp4a words per pixel
constexpr int SPW = CW + 1;    // shared-memory pixel stride in words (odd)

template <int R>
struct HeadS8 {
  static constexpr int COUT = 3 * R * R;
  static constexpr int COUTP = (COUT + 3) / 4 * 4;
  static constexpr int W_WORDS = 9 * CW * COUTP;
  static constexpr size_t SMEM = (size_t)W_WORDS * 4 +
                                 2 * COUTP * sizeof(float) +
                                 (size_t)(TH + 2) * (TW + 2) * SPW * 4;
};

template <int R>
__global__ void __launch_bounds__(THREADS)
head_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale,
               const float* __restrict__ bias,
               const uint8_t* __restrict__ orig, uint8_t* __restrict__ out,
               int B, int H, int W) {
  using C = HeadS8<R>;
  constexpr int COUT = C::COUT, COUTP = C::COUTP;
  extern __shared__ __align__(16) unsigned char smem[];
  int* ws = reinterpret_cast<int*>(smem);              // [9][CW][COUTP]
  float* ss = reinterpret_cast<float*>(ws + C::W_WORDS);  // [COUTP]
  float* bs = ss + COUTP;                              // [COUTP]
  int* xs = reinterpret_cast<int*>(bs + COUTP);        // [pix][SPW]

  const int tid = threadIdx.x;
  for (int i = tid; i < C::W_WORDS; i += THREADS) {
    const int co = i % COUTP, ciw = (i / COUTP) % CW, tap = i / (COUTP * CW);
    ws[i] = co < COUT ? reve::pack_s8x4(
                            w + ((size_t)tap * CIN + ciw * 4) * COUT + co, COUT)
                      : 0;
  }
  for (int i = tid; i < COUTP; i += THREADS) {
    ss[i] = i < COUT ? scale[i] : 0.f;
    bs[i] = i < COUT ? bias[i] : 0.f;
  }

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
    constexpr int VPP = CIN / 16;
    constexpr int NV = (TH + 2) * (TW + 2) * VPP;
    for (int i = tid; i < NV; i += THREADS) {
      const int pix = i / VPP, v = i - pix * VPP;
      const int r = pix / (TW + 2), c = pix - r * (TW + 2);
      const int gy = y0 - 1 + r, gx = x0 - 1 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        val = __ldg(reinterpret_cast<const uint4*>(
                        x + (((long long)b * H + gy) * W + gx) * CIN) + v);
      int* dst = xs + pix * SPW + v * 4;
      dst[0] = (int)val.x;
      dst[1] = (int)val.y;
      dst[2] = (int)val.z;
      dst[3] = (int)val.w;
    }
    __syncthreads();

    int acc[PIX][COUTP];
#pragma unroll
    for (int k = 0; k < PIX; ++k)
#pragma unroll
      for (int j = 0; j < COUTP; ++j) acc[k][j] = 0;

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
      const int* xr = xs + ((row + dy) * (TW + 2) + col + dx) * SPW;
      const int4* wr = reinterpret_cast<const int4*>(ws + tap * CW * COUTP);
#pragma unroll 2
      for (int ciw = 0; ciw < CW; ++ciw) {
        int xv[PIX];
#pragma unroll
        for (int k = 0; k < PIX; ++k) xv[k] = xr[k * 32 * SPW + ciw];
#pragma unroll
        for (int q = 0; q < COUTP / 4; ++q) {
          const int4 wv = wr[ciw * (COUTP / 4) + q];
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
      const int ox = x0 + col + 32 * k;
      if (oy >= H || ox >= W) continue;
      const uint8_t* o = orig + (((long long)b * H + oy) * W + ox) * 3;
      const float base[3] = {reve::u8_to_unit(o[0]), reve::u8_to_unit(o[1]),
                             reve::u8_to_unit(o[2])};
#pragma unroll
      for (int kk = 0; kk < COUT; ++kk) {
        const int c = kk / (R * R), i = (kk / R) % R, j = kk % R;
        // |acc| < 2^24: exact in float32; dequant + b stay float32
        const float hv =
            __fadd_rn(__fmul_rn((float)acc[k][kk], ss[kk]), bs[kk]);
        out[(((long long)b * H + oy) * R + i) * out_w * 3 +
            ((long long)ox * R + j) * 3 + c] = residual_u8(hv, base[c]);
      }
    }
  }
}

template <int R>
cudaError_t launch_s8(const void* x, const void* w, const float* scale,
                      const float* b, const uint8_t* orig, uint8_t* out,
                      int B, int H, int W, cudaStream_t stream) {
  auto kernel = head_s8_kernel<R>;
  const long long tiles =
      (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  int grid = 0;
  cudaError_t err = reve::persistent_grid(kernel, THREADS, HeadS8<R>::SMEM,
                                          tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, HeadS8<R>::SMEM, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), scale, b,
      orig, out, B, H, W);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 only (bfloat16 is conv3x3_tc.cu's); r in {2, 3, 4}.
// Returns a cudaError_t.
extern "C" int reve_head_conv_residual_u8_shuffle(
    const void* x, const void* w, const float* b, const uint8_t* orig,
    uint8_t* out, int B, int H, int W, int r, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_r(r, x, w, b, orig, out, B, H, W, s);
  return (int)cudaErrorInvalidValue;
}

// K4h: s8 head; r in {2, 3, 4}.  Returns a cudaError_t.
extern "C" int reve_head_conv_s8_residual_u8_shuffle(
    const void* x, const void* w, const float* scale, const float* b,
    const uint8_t* orig, uint8_t* out, int B, int H, int W, int r,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 2: return (int)launch_s8<2>(x, w, scale, b, orig, out, B, H, W, s);
    case 3: return (int)launch_s8<3>(x, w, scale, b, orig, out, B, H, W, s);
    case 4: return (int)launch_s8<4>(x, w, scale, b, orig, out, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
