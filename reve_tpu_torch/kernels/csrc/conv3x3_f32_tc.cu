// K1 conv3x3_bias_prelu and K2 head_conv_residual_u8_shuffle in float32,
// on the tensor cores as a six-pass bf16 product ("bf16x6"): one
// mainloop, two epilogues; and their split pass.
//
// Replaces (TPU side), at float32 with Precision.HIGHEST (srvgg.py:91-107):
//   K1  reve_tpu/models/srvgg.py:_conv3x3 + _prelu, the 16 hidden 64->64
//       layers of apply (srvgg.py:205-210): float32 accumulation, + b in
//       float32, PReLU in float32 with float32 alpha;
//   K2  the head _conv3x3 (srvgg.py:211-212) with
//       _epilogue(quantize_u8=True) (srvgg.py:239-262) and
//       reve_tpu/ops/pixel_shuffle.py:14-22: + b in float32 (no cast: the
//       compute dtype is float32), + repeat(u8 / 255, r^2) in float32,
//       u8(clip(y * 255 + 0.5, 0, 255)), stored in pixel-shuffle order.
// The int8 path's float32 calibration and certification passes run both.
// (RRDBNet's float32 conv_last, 64 -> 3 with no residual, is a kernel of
// its own: conv_last_f32.cu.)
//
// Scheme.  Each float32 value splits into three bf16 parts, hi = bf16(x),
// mid = bf16(x - hi), lo = bf16(x - hi - mid): each subtraction is exact
// in float32, so hi + mid + lo carries all 24 bits of x.  The conv sums
// the six products that matter, hi.hi, hi.mid, mid.hi, hi.lo, lo.hi and
// mid.mid (those left out are below 2^-24 of the result), on bf16 wgmma
// with float32 accumulators; a bf16 x bf16 product is exact in float32.
// That is how XLA computes a float32 Precision.HIGHEST product on the TPU.
// It is not TF32 (10 mantissa bits).  The tensor cores add in their own
// order and may truncate where IEEE addition rounds, so hi.hi accumulates
// in one register set and the five smaller products in another, added in
// float32 in the epilogue: the large sum takes 36 truncating steps, not
// 216.  The result is within 1e-4 of the plain float32 conv, not
// bit-exact (K2's u8 may differ by one where y * 255 + 0.5 sits near an
// integer).
//
// Bound on an H100 SXM per call of 4 1080p frames: K1 6 x 611.5 GFLOP /
// 989 TFLOP/s = 3.71 ms (operations), float32 in + out 4.25 GB -> 1.27 ms;
// K2 at r=4 6 x 458.6 GFLOP -> 2.78 ms (operations), 2.12 GB float32 +
// 25 MB u8 in + 398 MB u8 out -> 0.76 ms.  The CUDA-core forms they
// replace were bound at 9.13 and 6.85 ms (67 TFLOP/s).
//
// Design.
//  * split_bf16x3: an elementwise pass, float32 NHWC -> three bf16 NHWC
//    planes (3, B, H, W, 64), 8 values a thread (two 16-B loads, three
//    16-B stores), over a contiguous tensor or a channel slice of wider
//    pixels (K7's float32 input, rrdb.cu).  4 B in and 6 B out per value: 5.3 GB per call, 1.6 ms
//    at the card's bandwidth.  The wrappers launch it, then the conv.
//  * The conv is conv3x3_tc.cu's implicit GEMM (M = 64 pixels of a row,
//    N = 64 for K1, 3r^2 padded to a multiple of 8 for K2: 16, 32, 48;
//    K = 576 as 9 taps x 4 k16 steps), six wgmmas a step.  The three
//    planes' halos ((4+2) x (64+2) pixels, 128-B swizzle, three TMA
//    copies of one tensor map over the planes) take 153,600 B and are
//    single-buffered: the next tile's halo loads while this tile's
//    epilogue runs.  The weights' three splits (221,184 B for K1) cannot
//    stay resident beside them, so they stream tap by tap (the tap's
//    three splits, [split][k / 8][n][8], packed by the wrapper: 24,576 B
//    for K1, 18,432 B for K2 at r=4) through a ring of three stages by
//    bulk copies; all of them stay in L2.  A producer warp issues every
//    copy, so the four warpgroups run no branch between a wgmma and its
//    wait (ptxas serialises wgmmas that straddle one, C7518) and the
//    taps' wgmmas overlap.
//  * K1's epilogue writes float32 straight from the accumulator fragment
//    (8-B stores, whole 32-B sectors), with the reference's rounding:
//    __fadd_rn for + b, __fmul_rn for PReLU.  K2's is bf16 K2's (tc.cuh's
//    HeadEpilogue) with the value acc + cor + b in float32: it reads the
//    row's u8 pixels before the wgmmas, stages r output rows of 64r x 3
//    bytes in shuffle order and writes them as 16-B vectors.
// At 32, 96 and 128 features K1 and K2 in float32 are conv3x3_wide.cuh's
// template (the halo and weights streamed in units of 32 input channels),
// instantiated here behind their own entry points (the *_wide_* ones at
// the end of this file); this file's own template takes 64.
#include "conv3x3_wide.cuh"
#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace reve::tc;

constexpr int CIN = 64;
constexpr int TH = 4;   // tile rows, one warpgroup each
constexpr int TW = 64;  // tile columns: the M of one wgmma
constexpr int THREADS = 128 * TH + 32;  // + the producer warp
constexpr int PLANES = 3;  // hi, mid, lo
constexpr int HALO_TX = (TH + 2) * (TW + 2) * CIN * 2;  // one plane's copy
constexpr int HALO_BYTES = (HALO_TX + 1023) / 1024 * 1024;  // 1024-B aligned
constexpr int STAGES = 3;  // weight ring
using Grid = TileGrid<TH, TW>;

// R = 0: K1 (bias + PReLU, float32 out); R = 2, 3, 4: K2 (u8 residual +
// pixel shuffle at scale R).
template <int R>
struct F32 {
  using Epi = HeadEpilogue<R>;  // K2's; unused by K1
  static constexpr int COUT = R == 0 ? CIN : 3 * R * R;
  static constexpr int N = (COUT + 7) / 8 * 8;
  static constexpr int SPLIT_BYTES = CIN * N * 2;  // one tap, one split
  static constexpr int TAP_BYTES = PLANES * SPLIT_BYTES;
  // K2's staged output rows and input pixels, one area per warpgroup
  static constexpr int STAGE = R == 0 ? 0 : Epi::STAGE;
  static constexpr int ORIG = R == 0 ? 0 : Epi::ORIG;
  static constexpr size_t OFF_W = (size_t)PLANES * HALO_BYTES;
  static constexpr size_t OFF_STAGE = OFF_W + (size_t)STAGES * TAP_BYTES;
  static constexpr size_t OFF_ORIG = OFF_STAGE + TH * STAGE;
  static constexpr size_t OFF_PAR = OFF_ORIG + TH * ORIG;  // bias, alpha
  static constexpr size_t OFF_BAR = OFF_PAR + 2 * N * sizeof(float);
  // barriers: halo full, halo empty, then STAGES full, then STAGES empty
  static constexpr size_t SMEM = OFF_BAR + (2 + 2 * STAGES) * sizeof(uint64_t);
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

// Six wgmmas of one k16 step: `a` is the hi plane's A operand (mid and lo
// one and two halo buffers later), `w` the stage's hi weights (mid and lo
// one and two splits later).  hi.hi into `acc`, the five smaller products
// into `cor`, smallest first.
template <int N>
__device__ __forceinline__ void mma_bf16x6(float (&acc)[N / 2],
                                           float (&cor)[N / 2], uint32_t a,
                                           uint32_t w) {
  constexpr int SPLIT = CIN * N * 2;
  const uint64_t ah = desc_sw128(a), am = desc_sw128(a + HALO_BYTES),
                 al = desc_sw128(a + 2 * HALO_BYTES);
  const uint64_t bh = desc(w, N * 16), bm = desc(w + SPLIT, N * 16),
                 bl = desc(w + 2 * SPLIT, N * 16);
  Wgmma<N>::mma(cor, al, bh);
  Wgmma<N>::mma(cor, ah, bl);
  Wgmma<N>::mma(cor, am, bm);
  Wgmma<N>::mma(cor, am, bh);
  Wgmma<N>::mma(cor, ah, bm);
  Wgmma<N>::mma(acc, ah, bh);
}

template <int R>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_f32_tc_kernel(const __grid_constant__ CUtensorMap map,
                      const bf16* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ alpha,
                      const uint8_t* __restrict__ orig,
                      void* __restrict__ out, int B, int H, int W) {
  using F = F32<R>;
  using Epi = typename F::Epi;
  constexpr int N = F::N, COUT = F::COUT, TAP_BYTES = F::TAP_BYTES;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;  // warpgroup = tile row

  float* bs = reinterpret_cast<float*>(smem + F::OFF_PAR);
  float* as = bs + N;
  for (int i = tid; i < N; i += THREADS) {
    bs[i] = i < COUT ? bias[i] : 0.f;
    as[i] = R == 0 ? alpha[i] : 0.f;
  }
  const uint32_t halo_full = base + (uint32_t)F::OFF_BAR;
  const uint32_t halo_empty = halo_full + 8;
  const uint32_t w_full = halo_full + 16;
  const uint32_t w_empty = w_full + 8 * STAGES;
  if (tid == 0) {
    mbar_init(halo_full, 1);
    mbar_init(halo_empty, TH);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, TH);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Grid g(B, H, W);

  if (wg == TH) {
    // The producer warp: one thread issues every copy, in the order the
    // warpgroups free the buffers.  Tap gi (the block's gi-th weight
    // stage, tap gi % 9 of its tile gi / 9) waits for the warpgroups to
    // release tap gi - STAGES; a tile's halo, issued after its tap 0's
    // weights, waits for them to finish the tile before.
    if (t != 0) return;
    auto load_halo = [&](long long tile) {
      int b, y0, x0;
      g.origin(tile, b, y0, x0);
      mbar_expect_tx(halo_full, PLANES * HALO_TX);
      for (int q = 0; q < PLANES; ++q)
        tma_load_4d(base + q * HALO_BYTES, &map, halo_full, 0, x0 - 1,
                    y0 - 1, q * B + b);
    };
    const long long tiles =
        (g.count - blockIdx.x + gridDim.x - 1) / gridDim.x;
    load_halo(blockIdx.x);  // the grid never exceeds the tile count
    for (long long gi = 0; gi < 9 * tiles; ++gi) {
      const int s = (int)(gi % STAGES);
      if (gi >= STAGES)
        mbar_wait(w_empty + 8 * s, (uint32_t)((gi / STAGES - 1) & 1));
      mbar_expect_tx(w_full + 8 * s, TAP_BYTES);
      bulk_load(base + (uint32_t)(F::OFF_W + s * TAP_BYTES),
                w + (gi % 9) * (TAP_BYTES / 2), TAP_BYTES, w_full + 8 * s);
      if (gi % 9 == 0 && gi > 0) {
        const long long it = gi / 9;
        mbar_wait(halo_empty, (uint32_t)((it - 1) & 1));
        load_halo(blockIdx.x + it * gridDim.x);
      }
    }
    return;
  }

  // The warpgroups: no branch between a wgmma and its wait (the releases
  // are predicated arrivals), so the wgmmas of consecutive taps overlap.
  const int lane = t & 31;
  const int p0 = (t >> 5) * 16 + (lane >> 2), c0 = (lane & 3) * 2;
  long long tile = blockIdx.x;
  for (long long it = 0; tile < g.count; tile += gridDim.x, ++it) {
    int b, y0, x0;
    g.origin(tile, b, y0, x0);
    const int oy = y0 + wg;
    const int valid = min(TW, W - x0);  // pixels of this row in the frame
    // K2 reads the row's u8 input pixels before the wgmmas; the loads
    // land while the tensor cores work
    uint8_t o0 = 0, o1 = 0;
    if constexpr (R > 0)
      Epi::load_orig(orig, b, oy, x0, H, W, valid, t, o0, o1);
    mbar_wait(halo_full, (uint32_t)(it & 1));
    float acc[N / 2], cor[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = cor[i] = 0.f;
    const uint32_t a_row = base + wg * (TW + 2) * CIN * 2;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const long long gi = it * 9 + tap;
      const int s = (int)(gi % STAGES);
      mbar_wait(w_full + 8 * s, (uint32_t)((gi / STAGES) & 1));
      const uint32_t a = a_row + ((tap / 3) * (TW + 2) + tap % 3) * CIN * 2;
      const uint32_t ws = base + (uint32_t)(F::OFF_W + s * TAP_BYTES);
      fence_regs(acc);
      fence_regs(cor);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < CIN / 16; ++kc)
        mma_bf16x6<N>(acc, cor, a + kc * 32, ws + 2 * kc * N * 16);
      wgmma_commit();
      fence_regs(acc);
      fence_regs(cor);
      // the previous tap's wgmmas are done: release its stage
      if (tap < 8) {
        wgmma_wait<1>();
        if (tap > 0)
          mbar_arrive_if(w_empty + 8 * (int)((gi - 1) % STAGES), t == 0);
      } else {
        wgmma_wait<0>();
        mbar_arrive_if(w_empty + 8 * (int)((gi - 1) % STAGES), t == 0);
        mbar_arrive_if(w_empty + 8 * s, t == 0);
        mbar_arrive_if(halo_empty, t == 0);  // the halo may be refilled
      }
    }
    fence_regs(acc);
    fence_regs(cor);

    // accumulator fragment: register 4j + 2h + e holds pixel
    // 16 * warp + lane / 4 + 8h, channel 8j + 2 * (lane % 4) + e
    if constexpr (R == 0) {
      if (oy < H) {
        float* yr =
            static_cast<float*>(out) + ((long long)b * H + oy) * W * COUT;
#pragma unroll
        for (int j = 0; j < COUT / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = p0 + 8 * h, c = 8 * j + c0;
            if (x0 + p >= W) continue;
            // conv + b in float32; PReLU in float32:
            // max(v, 0) + alpha * min(v, 0)
            float v0 = __fadd_rn(
                __fadd_rn(acc[4 * j + 2 * h], cor[4 * j + 2 * h]), bs[c]);
            float v1 = __fadd_rn(
                __fadd_rn(acc[4 * j + 2 * h + 1], cor[4 * j + 2 * h + 1]),
                bs[c + 1]);
            v0 = v0 > 0.f ? v0 : __fmul_rn(as[c], v0);
            v1 = v1 > 0.f ? v1 : __fmul_rn(as[c + 1], v1);
            *reinterpret_cast<float2*>(yr + (long long)(x0 + p) * COUT + c) =
                make_float2(v0, v1);
          }
      }
    } else {
      // conv + b in float32, no cast (the compute dtype is float32)
      Epi::template row<N>(
          smem + F::OFF_STAGE + wg * F::STAGE,
          smem + F::OFF_ORIG + wg * F::ORIG, static_cast<uint8_t*>(out), b,
          oy, x0, H, W, valid, wg, t, o0, o1, [&](int q, int kk) {
            return __fadd_rn(__fadd_rn(acc[q], cor[q]), bs[kk]);
          });
    }
  }
}

// The split of `rows` rows of `cols` float32 values, `stride` values
// apart, into planes hi, mid, lo of rows x cols bf16 each; 8 values a
// thread.  stride == cols: a contiguous run (float32 K1's and K2's
// input), read without the row arithmetic; else a channel slice of NHWC
// pixels (K7's input in float32).
__global__ void __launch_bounds__(256)
split_bf16x3_kernel(const float* __restrict__ x, uint4* __restrict__ out,
                    long long rows, int cols, int stride) {
  const int g8 = cols / 8;
  const long long n8 = rows * g8;
  const bool flat = stride == cols;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n8;
       i += (long long)gridDim.x * blockDim.x) {
    long long at = i * 8;
    if (!flat) {
      const long long r = i / g8;
      at = r * stride + (i - r * g8) * 8;
    }
    const float4* src = reinterpret_cast<const float4*>(x + at);
    const float4 a = src[0], c = src[1];
    uint4 h, m, l;
    split2(a.x, a.y, h.x, m.x, l.x);
    split2(a.z, a.w, h.y, m.y, l.y);
    split2(c.x, c.y, h.z, m.z, l.z);
    split2(c.z, c.w, h.w, m.w, l.w);
    out[i] = h;
    out[n8 + i] = m;
    out[2 * n8 + i] = l;
  }
}

// A grid-stride launch of 256-thread blocks over n8 groups of 8 values:
// at most 8 blocks an SM.
cudaError_t split_grid(long long n8, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long blocks = (n8 + 255) / 256;
  *grid = (int)(blocks < 8LL * sms ? blocks : 8LL * sms);
  return cudaSuccess;
}

template <int R>
cudaError_t launch(const void* planes, const void* wp, const float* b,
                   const float* alpha, const uint8_t* orig, void* out, int B,
                   int H, int W, cudaStream_t stream) {
  const long long tiles =
      (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  CUtensorMap map;
  cudaError_t err =
      halo_map(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, planes, PLANES * B,
               H, W, TW + 2, TH + 2, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kernel = conv3x3_f32_tc_kernel<R>;
  int grid = 0;
  err = reve::persistent_grid(kernel, THREADS, F32<R>::SMEM, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, F32<R>::SMEM, stream>>>(
      map, static_cast<const bf16*>(wp), b, alpha, orig, out, B, H, W);
  return cudaGetLastError();
}

}  // namespace

// The split pass over `rows` rows of `cols` float32 values (a multiple of
// 8) whose starts lie `stride` values apart (a multiple of 4; `x` 16-B
// aligned; stride == cols for a contiguous tensor) -> planes hi, mid, lo
// of rows x cols bf16 each, one after the other in `out`.  Returns a
// cudaError_t (0 = success).
extern "C" int reve_split_bf16x3(const void* x, void* out, long long rows,
                                 int cols, int stride, void* stream) {
  if (cols % 8 || stride % 4 || stride < cols)
    return (int)cudaErrorInvalidValue;
  const long long n8 = rows * (cols / 8);
  if (n8 == 0) return (int)cudaSuccess;
  int grid = 0;
  const cudaError_t err = split_grid(n8, &grid);
  if (err != cudaSuccess) return (int)err;
  split_bf16x3_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint4*>(out), rows, cols,
      stride);
  return (int)cudaGetLastError();
}

// float32 K1 on the split planes (3, B, H, W, 64) bf16 of its input, with
// the weights packed by the wrapper as [tap][split][k / 8][n][8] bf16.
// Returns a cudaError_t (0 = success).
extern "C" int reve_conv3x3_bias_prelu_f32tc(const void* planes,
                                             const void* wp, const float* b,
                                             const float* alpha, void* y,
                                             int B, int H, int W,
                                             void* stream) {
  return (int)launch<0>(planes, wp, b, alpha, nullptr, y, B, H, W,
                        static_cast<cudaStream_t>(stream));
}

// float32 K2 on the split planes of its input, the weights packed as K1's
// with n padded with zeros to 3r^2 rounded up to a multiple of 8; `b`:
// 3r^2 float32; r in {2, 3, 4}.  Returns a cudaError_t (0 = success).
extern "C" int reve_head_conv_residual_u8_shuffle_f32tc(
    const void* planes, const void* wp, const float* b, const uint8_t* orig,
    uint8_t* out, int B, int H, int W, int r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 2: return (int)launch<2>(planes, wp, b, nullptr, orig, out, B, H, W,
                                  s);
    case 3: return (int)launch<3>(planes, wp, b, nullptr, orig, out, B, H, W,
                                  s);
    case 4: return (int)launch<4>(planes, wp, b, nullptr, orig, out, B, H, W,
                                  s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K1 in float32 at feat = 32, 96 or 128 channels (64 is the kernel
// above): conv3x3_wide.cuh's units of 32 input channels.  `planes`: the
// split planes (3, B, H, W, feat) bf16 of the input; `w`: the HWIO
// weights packed by kernels/conv3x3.py pack_weights_wide, three splits.
// Returns a cudaError_t (0 = success).
extern "C" int reve_conv3x3_bias_prelu_wide_f32tc(
    const void* planes, const void* w, const float* b, const float* alpha,
    void* y, int B, int H, int W, int feat, void* stream) {
  return (int)reve::wide::k1<3>(planes, w, b, alpha, y, B, H, W, feat,
                                static_cast<cudaStream_t>(stream));
}

// K2 in float32 at feat = 32, 96 or 128 input channels, r in {2, 3, 4}:
// the weights packed as K1's at these widths, n padded with zeros to 3r^2
// rounded up to a multiple of 8; `b`: 3r^2 float32.  Returns a
// cudaError_t (0 = success).
extern "C" int reve_head_conv_residual_u8_shuffle_wide_f32tc(
    const void* planes, const void* w, const float* b, const uint8_t* orig,
    uint8_t* out, int B, int H, int W, int feat, int r, void* stream) {
  return (int)reve::wide::k2<3>(planes, w, b, orig, out, B, H, W, feat, r,
                                static_cast<cudaStream_t>(stream));
}
