// The s8 convs of the int8 SRVGG, NHWC, on s8 wgmma: one mainloop, two
// epilogues.
//
// K4 conv3x3_s8_dq_prelu_q8: one hidden layer of the int8 body:
//   acc = conv3x3(x8, w8)                      s8 x s8 -> s32, SAME zero pad
//   fy  = float32(acc) * scale[c] + b[c]       scale = act_scale[i] * sw[i]
//   p   = max(fy, 0) + alpha[c] * min(fy, 0)   PReLU in float32, float32 alpha
//   y8  = clip(round(p * inv), -127, 127)      inv = 1 / act_scale[i + 1]
// Replaces (TPU side): reve_tpu/models/srvgg.py:380-382, the classic-domain
// loop of apply_int8 (_conv3x3_s8 :268-276, dq_prelu :322-329, _quant_s8
// :279-288), which XLA fused into one s8 conv with its epilogue.
//
// K4h head_conv_s8_residual_u8_shuffle: the int8 head, 64 -> 3r^2:
//   h   = float32(acc) * scale[n] + b[n]       scale = act_scale[n] * sw_last;
//                                              NO cast to the compute dtype
//   y   = h + repeat(u8 * (1/255), r^2)        float32 residual
//   out = u8(clip(y * 255 + 0.5, 0, 255))      truncating cast
// stored straight to (B, H*r, W*r, 3) in torch's pixel-shuffle order.
// Replaces reve_tpu/models/srvgg.py:383-386 (int8_head) with _epilogue
// (:251-262) and reve_tpu/ops/pixel_shuffle.py:14-22.
//
// Bound on an H100 SXM per call at the main path's batch of 4 1920x1080
// frames: K4 611.5 GOP / 1979 TOP/s (s8 tensor, dense) = 0.31 ms; 531 MB
// of s8 in + 531 MB out = 1.06 GB / 3.35 TB/s = 0.32 ms, so bytes by a
// hair.  K4h at r=4 458.6 GOP -> 0.23 ms; 531 MB s8 + 25 MB u8 in + 398 MB
// u8 out -> 0.29 ms (bytes).
//
// Design: conv3x3_tc.cu's persistent implicit GEMM on s8 wgmma (m64nNk32,
// s32 accumulators in registers; N = 64 for K4, 3r^2 padded to a multiple
// of 8 for K4h: 16, 32, 48): 9 taps x 2 k32 steps = 18 wgmmas per 64-pixel
// row.  Integer accumulation is exact, so both kernels are bit-exact
// against their plain versions.
//  * Blocks of 2 warpgroups walk tiles of 2 rows x 64 pixels, one row per
//    warpgroup: the epilogue, on the CUDA cores, takes longer than the
//    wgmmas, and one block's epilogue runs while another block's wgmmas
//    do.  K4 runs two blocks on each SM (80 KB of shared memory and 112
//    registers a thread; 10% faster than one block of 4 warpgroups on an
//    H100 SXM, three blocks of one warpgroup were slower); K4h three
//    (70 KB at r=4, at most 76 registers; perf_conv_tc_parts times it at
//    two as `two_blocks`).  The weights
//    (9 x 64 x N bytes: 36,864 for K4, 27,648 for K4h at r=4;
//    packed by the wrapper as B K-major [k / 16][n][16], zeros for the
//    padded n: core matrices of 8 rows x 16 B, no swizzle) are resident
//    per block.
//  * The halo ((2+2) x (64+2) pixels x 64 B) comes in by one TMA copy per
//    tile into one of two buffers, so the next tile's halo loads while
//    this tile computes.  The tensor map's type is UINT8 (there is no s8
//    type; bytes are bytes), and its zero fill outside the frame is s8
//    zero, SAME padding.  A pixel is a 64-B row of the A operand, in the
//    64-B swizzle (groups of 8 rows 512 B apart); tap (dy, dx) starts
//    dy * 66 + dx rows later, base offset 0 (see tc.cuh).
//  * The epilogues round exactly where the reference does: __fmul_rn and
//    __fadd_rn keep nvcc from contracting the dequant into an FMA.  Each
//    thread keeps its N / 4 channels' scale and bias (and K4's alpha) in
//    registers.  K4 quantizes half to even (reve::quant_s8, one
//    saturating conversion), stages its row's 64 x 64 s8 outputs in
//    shared memory (16-B chunks XOR-swizzled by pixel) and writes them as
//    16-B vectors, one contiguous 4 KB run per row.  K4h is bf16 K2's
//    epilogue (tc.cuh's HeadEpilogue): it reads the row's u8 pixels while
//    the tensor cores work, stages r output rows of 64r x 3 bytes in
//    shuffle order and writes them as 16-B vectors.  The epilogue is the
//    larger part of both kernels' time (perf_conv_tc_parts on an H100
//    SXM).  K4's parameters in registers and its quantize as one
//    conversion took a fifth off K4; K4h's epilogue reads the residual
//    bases once per pixel and colour and clips as one saturating
//    conversion (common.cuh).
//
// At 32, 96 and 128 features K4 and K4h are conv3x3_s8_wide.cuh's
// template (the halo streamed in units of 32 input channels, consumer
// teams taking tiles in turn), instantiated here behind their own entry
// points (the *_wide ones at the end); the 64-feature kernels above are
// unchanged.
#include "conv3x3_s8_wide.cuh"
#include "tc.cuh"

namespace {

using namespace reve::tc;

constexpr int C = 64;   // channels in: one s8 pixel is 64 B
constexpr int TH = 2;   // tile rows, one warpgroup each
constexpr int TW = 64;  // tile columns: the M of one wgmma
constexpr int THREADS = 128 * TH;
constexpr int HALO_TX = (TH + 2) * (TW + 2) * C;  // bytes of one copy
constexpr int HALO_BYTES = (HALO_TX + 1023) / 1024 * 1024;  // 1024-B aligned
using Grid = TileGrid<TH, TW>;

// R = 0: K4 (dequant + PReLU + requant, s8 out); R = 2, 3, 4: K4h (u8
// residual + pixel shuffle at scale R).
template <int R>
struct S8 {
  using Epi = HeadEpilogue<R>;  // K4h's; unused by K4
  static constexpr int COUT = R == 0 ? C : 3 * R * R;
  static constexpr int N = (COUT + 7) / 8 * 8;
  static constexpr int W_BYTES = 9 * C * N;
  // staged output of one warpgroup's row: 64 x 64 s8, or R rows of
  // 64R x 3 u8; then the row's u8 input pixels (K4h)
  static constexpr int STAGE = R == 0 ? TW * C : Epi::STAGE;
  static constexpr int ORIG = R == 0 ? 0 : Epi::ORIG;
  static constexpr size_t OFF_W = 2 * HALO_BYTES;
  static constexpr size_t OFF_STAGE = OFF_W + W_BYTES;
  static constexpr size_t OFF_ORIG = OFF_STAGE + TH * STAGE;
  static constexpr size_t OFF_PAR = OFF_ORIG + TH * ORIG;  // scale, b, alpha
  static constexpr size_t OFF_BAR = OFF_PAR + 3 * N * sizeof(float);
  static constexpr size_t SMEM = OFF_BAR + 2 * sizeof(uint64_t);
  // blocks on each SM: K4's registers allow two, K4h's three
  static constexpr int BLOCKS = R == 0 ? 2 : 3;
};

// Start the copy of the halo of the tile at (b, y0, x0) into `dst`,
// completing on `bar`: box (64 channels, TW + 2, TH + 2, 1) at (0, x0 - 1,
// y0 - 1, b), zeros outside the frame.
__device__ __forceinline__ void load_halo(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int b, int y0,
                                          int x0) {
  mbar_expect_tx(bar, HALO_TX);
  tma_load_4d(dst, map, bar, 0, x0 - 1, y0 - 1, b);
}

// Issue the 18 wgmma steps of one warpgroup's row, asynchronously:
// `a_row` is halo pixel (row, 0), and tap (dy, dx) starts dy * (TW + 2) +
// dx pixels later; k32 step kc is 32 B into each row.
template <int N>
__device__ __forceinline__ void issue_mma(int (&acc)[N / 2], uint32_t a_row,
                                          uint32_t w) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
    for (int kc = 0; kc < C / 32; ++kc) {
      const uint32_t a =
          a_row + ((tap / 3) * (TW + 2) + tap % 3) * C + kc * 32;
      const uint32_t b = w + (tap * 4 + 2 * kc) * N * 16;
      WgmmaS8<N>::mma(acc, desc_sw64(a), desc(b, N * 16));
    }
  }
  wgmma_commit();
}

// Wait for the warpgroup's wgmmas: `acc` is final only after this.
template <int N>
__device__ __forceinline__ void wait_mma(int (&acc)[N / 2]) {
  wgmma_wait<0>();
  fence_regs(acc);  // keep every read of the accumulators below the wait
}

template <int R>
__global__ void __launch_bounds__(THREADS, S8<R>::BLOCKS)
conv3x3_s8_tc_kernel(const __grid_constant__ CUtensorMap map,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const float* __restrict__ alpha,
                     const float* __restrict__ inv_next,
                     const uint8_t* __restrict__ orig, void* __restrict__ out,
                     int B, int H, int W) {
  using S = S8<R>;
  using Epi = typename S::Epi;
  constexpr int N = S::N, COUT = S::COUT;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;  // warpgroup = tile row

  // the packed weights, as they are
  const uint4* wsrc = reinterpret_cast<const uint4*>(w);
  uint4* ws = reinterpret_cast<uint4*>(smem + S::OFF_W);
  for (int i = tid; i < S::W_BYTES / 16; i += THREADS) ws[i] = wsrc[i];
  float* ss = reinterpret_cast<float*>(smem + S::OFF_PAR);
  float* bs = ss + N;
  float* as = bs + N;
  for (int i = tid; i < N; i += THREADS) {
    ss[i] = i < COUT ? scale[i] : 0.f;
    bs[i] = i < COUT ? bias[i] : 0.f;
    as[i] = R == 0 ? alpha[i] : 0.f;
  }
  const float inv = R == 0 ? *inv_next : 0.f;
  const uint32_t bar = base + (uint32_t)S::OFF_BAR;  // one per buffer
  if (tid == 0) {
    mbar_init(bar);
    mbar_init(bar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();

  const Grid g(B, H, W);
  long long tile = blockIdx.x;  // the grid never exceeds the tile count
  int b, y0, x0;
  if (tid == 0) {
    g.origin(tile, b, y0, x0);
    load_halo(base, &map, bar, b, y0, x0);
  }
  const int lane = t & 31;
  const int p0 = (t >> 5) * 16 + (lane >> 2), c0 = (lane & 3) * 2;
  // this thread's N / 4 channels (8j + c0 + e) of scale, bias and alpha
  float sc[N / 4], bi[N / 4], al[N / 4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[2 * j + e] = ss[8 * j + c0 + e];
      bi[2 * j + e] = bs[8 * j + c0 + e];
      al[2 * j + e] = as[8 * j + c0 + e];
    }
  unsigned char* st = smem + S::OFF_STAGE + wg * S::STAGE;
  for (int it = 0; tile < g.count; tile += gridDim.x, ++it) {
    // this tile's halo has landed (the buffer's use it / 2), and every
    // warpgroup is done with the other buffer and with its staging area
    mbar_wait(bar + (it & 1) * 8, (it >> 1) & 1);
    __syncthreads();
    const long long next = tile + gridDim.x;
    if (tid == 0 && next < g.count) {
      g.origin(next, b, y0, x0);
      load_halo(base + ((it + 1) & 1) * HALO_BYTES, &map,
                bar + ((it + 1) & 1) * 8, b, y0, x0);
    }

    g.origin(tile, b, y0, x0);
    const int oy = y0 + wg;
    const int valid = min(TW, W - x0);  // pixels of this row in the frame
    int acc[N / 2];
    issue_mma<N>(acc, base + (it & 1) * HALO_BYTES + wg * (TW + 2) * C,
                 base + (uint32_t)S::OFF_W);
    // K4h reads the row's u8 input pixels while the tensor cores work
    uint8_t o0 = 0, o1 = 0;
    if constexpr (R > 0)
      Epi::load_orig(orig, b, oy, x0, H, W, valid, t, o0, o1);
    wait_mma<N>(acc);

    // accumulator fragment: register 4j + 2h + e holds pixel
    // 16 * warp + lane / 4 + 8h, channel 8j + 2 * (lane % 4) + e
    if constexpr (R == 0) {
      // pixel p's 16-B chunk q is staged at chunk q ^ ((p / 2) % 4)
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + 8 * h, c = 8 * j + c0;
          uint32_t two = 0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // |acc| <= 9*64*127^2 < 2^24: the float32 conversion is exact
            const float fy =
                __fadd_rn(__fmul_rn((float)acc[4 * j + 2 * h + e],
                                    sc[2 * j + e]),
                          bi[2 * j + e]);
            const float pr = fy > 0.f ? fy : __fmul_rn(al[2 * j + e], fy);
            two |= reve::quant_s8(pr, inv) << (8 * e);
          }
          *reinterpret_cast<uint16_t*>(
              st + p * C + (((c >> 4) ^ ((p >> 1) & 3)) << 4) + (c & 15)) =
              (uint16_t)two;
        }
      warpgroup_sync(wg);
      if (oy < H) {
        int8_t* yr =
            static_cast<int8_t*>(out) + ((long long)b * H + oy) * W * C;
        for (int q = t; q < TW * (C / 16); q += 128) {
          const int p = q >> 2, ch = q & 3;
          if (x0 + p < W)
            *reinterpret_cast<uint4*>(yr + (long long)(x0 + p) * C +
                                      ch * 16) =
                *reinterpret_cast<const uint4*>(
                    st + p * C + ((ch ^ ((p >> 1) & 3)) << 4));
        }
      }
    } else {
      // exact float32 conversion (|acc| < 2^24); the dequant and + b stay
      // float32, with no cast to the compute dtype.  Register q = 4j + 2h
      // + e holds channel 8j + c0 + e, whose parameters are sc, bi[2j + e]
      Epi::template row<N>(
          st, smem + S::OFF_ORIG + wg * S::ORIG, static_cast<uint8_t*>(out),
          b, oy, x0, H, W, valid, wg, t, o0, o1, [&](int q, int) {
            const int pj = q / 4 * 2 + q % 2;
            return __fadd_rn(__fmul_rn((float)acc[q], sc[pj]), bi[pj]);
          });
    }
  }
}

template <int R>
cudaError_t launch(const void* x, const void* wp, const float* scale,
                   const float* bias, const float* alpha,
                   const float* inv_next, const uint8_t* orig, void* out,
                   int B, int H, int W, cudaStream_t stream) {
  const long long tiles =
      (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  CUtensorMap map;
  cudaError_t err = halo_map(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, B, H,
                             W, TW + 2, TH + 2, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return err;
  auto kernel = conv3x3_s8_tc_kernel<R>;
  int grid = 0;
  err = reve::persistent_grid(kernel, THREADS, S8<R>::SMEM, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, S8<R>::SMEM, stream>>>(
      map, static_cast<const int8_t*>(wp), scale, bias, alpha, inv_next,
      orig, out, B, H, W);
  return cudaGetLastError();
}

}  // namespace

// K4.  `wp`: the weights packed by the wrapper as [k / 16][n][16] s8 (k =
// tap * 64 + ci, n = co).  Returns a cudaError_t (0 = success).
extern "C" int reve_conv3x3_s8_dq_prelu_q8(const void* x, const void* wp,
                                           const float* scale,
                                           const float* bias,
                                           const float* alpha,
                                           const float* inv_next, void* y,
                                           int B, int H, int W,
                                           void* stream) {
  return (int)launch<0>(x, wp, scale, bias, alpha, inv_next, nullptr, y, B,
                        H, W, static_cast<cudaStream_t>(stream));
}

// K4h; r in {2, 3, 4}.  `wp`: the weights packed as K4's, n padded with
// zeros to 3r^2 rounded up to a multiple of 8.  `scale`, `b`: 3r^2
// float32 each.  Returns a cudaError_t (0 = success).
extern "C" int reve_head_conv_s8_residual_u8_shuffle_tc(
    const void* x, const void* wp, const float* scale, const float* b,
    const uint8_t* orig, uint8_t* out, int B, int H, int W, int r,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 2:
      return (int)launch<2>(x, wp, scale, b, nullptr, nullptr, orig, out, B,
                            H, W, s);
    case 3:
      return (int)launch<3>(x, wp, scale, b, nullptr, nullptr, orig, out, B,
                            H, W, s);
    case 4:
      return (int)launch<4>(x, wp, scale, b, nullptr, nullptr, orig, out, B,
                            H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K4 at `feat` (32, 96, 128) input and output channels
// (conv3x3_s8_wide.cuh).  `wp`: the weights packed as [unit][tap][k /
// 16][n][16] s8 (kernels/conv3x3_s8.py pack_weights_s8_wide, kept by
// packed_s8_wide).  Returns a cudaError_t (0 = success).
extern "C" int reve_conv3x3_s8_dq_prelu_q8_wide(
    const void* x, const void* wp, const float* scale, const float* bias,
    const float* alpha, const float* inv_next, void* y, int B, int H, int W,
    int feat, void* stream) {
  return (int)reve::s8wide::k4(x, wp, scale, bias, alpha, inv_next, y, B, H,
                               W, feat, static_cast<cudaStream_t>(stream));
}

// K4h at `feat` (32, 96, 128) input channels and r in {2, 3, 4}
// (conv3x3_s8_wide.cuh).  `wp`: packed as K4's at that width, n padded
// with zeros to 3r^2 rounded up to a multiple of 8.  Returns a cudaError_t
// (0 = success).
extern "C" int reve_head_conv_s8_residual_u8_shuffle_wide_tc(
    const void* x, const void* wp, const float* scale, const float* b,
    const uint8_t* orig, uint8_t* out, int B, int H, int W, int feat, int r,
    void* stream) {
  return (int)reve::s8wide::k4h(x, wp, scale, b, orig, out, B, H, W, feat, r,
                                static_cast<cudaStream_t>(stream));
}
