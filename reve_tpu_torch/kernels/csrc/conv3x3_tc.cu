// K1 conv3x3_bias_prelu and K2 head_conv_residual_u8_shuffle in bfloat16,
// on the tensor cores: one implicit-GEMM mainloop (wgmma), two epilogues.
//
// Replaces (TPU side), in bfloat16 (float32 K1 and K2 are
// conv3x3_f32_tc.cu's, a six-pass bf16 split on wgmma that matches
// Precision.HIGHEST, which TF32 would not):
//   K1  reve_tpu/models/srvgg.py:_conv3x3 + _prelu (srvgg.py:88-113), the
//       16 hidden 64->64 layers of apply (srvgg.py:205-210);
//   K2  the head _conv3x3 (srvgg.py:211-212) with _epilogue(quantize_u8=True)
//       (srvgg.py:239-262) and reve_tpu/ops/pixel_shuffle.py:14-22, also
//       reached from apply_int8(int8_head=False) (srvgg.py:204-205);
//       at r = 1 with no residual, RRDBNet's conv_last (64 -> 3,
//       reve_tpu/models/rrdb.py:232-233) with the engine's u8 rounding
//       (reve_tpu/pipeline/engine.py:428-429): u8(clip(float32(bf16(acc +
//       b)) * 255 + 0.5, 0, 255)), the residual epilogue on a zero base.
// Both were one XLA-fused conv graph on the TPU.  What they compute, and
// where they round, is that of the plain versions (kernels/conv3x3.py,
// kernels/head.py) and of common.cuh.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor, 3.35 TB/s) per call of 4
// 1080p frames: K1 611.5 GFLOP -> 0.618 ms, 2.12 GB in + out -> 0.634 ms,
// at the card's ridge (288 FLOP/byte against 295); K2 at r=4 458.6 GFLOP
// -> 0.464 ms (operations), 1.49 GB -> 0.44 ms.  Only the tensor cores get
// near either bound: the CUDA-core forms top out at ~67 TFLOP/s.
//
// Design.  Each conv is a GEMM of M = output pixels, N = output channels
// (64 for K1; 3r^2 padded to a multiple of 8 for K2: 16, 32, 48) and
// K = 9 taps x 64 input channels = 576, as 36 wgmma m64nNk16 steps with
// float32 accumulators in registers.
//  * Persistent blocks, one per SM, of 4 warpgroups.  A block loads the
//    weights into shared memory once (73,728 B for K1, 55,296 B for K2 at
//    r=4) and walks tiles of 4 rows x 64 pixels, one row per warpgroup, so
//    one row is one wgmma M of 64.
//  * The halo tile ((4+2) x (64+2) pixels x 64 channels) comes in as one
//    TMA copy of a 4-D tensor map over the NHWC input, into one of two
//    buffers: the next tile's halo loads while this tile's wgmmas and
//    epilogue run.  The copy fills what lies outside the frame with zeros,
//    which is exactly SAME padding, and needs no per-thread address work.
//    TMA rather than cp.async: 16-B cp.async copies from every thread
//    reached about half the card's bandwidth (the loads alone took longer
//    than the wgmmas), and one bulk copy per tile does not.  The tensor
//    map is encoded per call (the input pointer changes), through
//    cuTensorMapEncodeTiled from cudaGetDriverEntryPoint, so the library
//    needs no libcuda at link time, and is passed as a __grid_constant__.
//  * A halo pixel is one 128-B row (64 bf16 channels), stored in the 128-B
//    swizzle that wgmma reads for a K-major A operand: the 16-B chunk c of
//    pixel p sits at chunk c ^ (p % 8).  The A operand of tap (dy, dx) is
//    the halo started dy * 66 + dx pixels later.  The swizzle is a function
//    of the shared-memory address bits (the buffers are 1024-B aligned),
//    both where TMA writes and where wgmma reads, so a start moved by whole
//    128-B rows reads what TMA wrote, with the descriptor's base offset 0.
//    The weights sit as [k / 8][n][8] (B K-major, no swizzle: core
//    matrices of 8 rows x 16 B), transposed from HWIO when loaded.
//  * Epilogues keep the reference's rounding (__fadd_rn, __fmul_rn,
//    __float2bfloat16_rn; no FMA contraction).  K1 stages its bf16 row of
//    64 x 64 in shared memory (16-B chunks XOR-swizzled by pixel) and writes
//    it as 16-B vectors, one contiguous 8 KB run per row.  K2 reads the
//    row's u8 pixels once, stages its r output rows of 64r x 3 bytes in
//    shared memory in pixel-shuffle order, and writes each as 16-B vectors
//    (tc.cuh's HeadEpilogue, which float32 K2 and K4h share).
// The barrier, TMA, descriptor and wgmma helpers are tc.cuh's.
// At 32, 96 and 128 features K1 and K2 in bfloat16 are conv3x3_wide.cuh's
// template (the halo and weights streamed in units of 32 input channels),
// instantiated here behind their own entry points (the *_wide_* ones at
// the end of this file); this file's own template takes 64.
#include "conv3x3_wide.cuh"
#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using reve::round_to;
using namespace reve::tc;

constexpr int CIN = 64;
constexpr int TH = 4;   // tile rows, one warpgroup each
constexpr int TW = 64;  // tile columns: the M of one wgmma
constexpr int THREADS = 128 * TH;
constexpr int HALO_TX = (TH + 2) * (TW + 2) * CIN * 2;  // bytes of one copy
constexpr int HALO_BYTES = (HALO_TX + 1023) / 1024 * 1024;  // 1024-B aligned
using Grid = TileGrid<TH, TW>;

// R = 0: K1 (bias + PReLU, bf16 out); R = 2, 3, 4: K2 (u8 residual +
// pixel shuffle at scale R); R = 1: K2's conv_last mode (no residual: the
// epilogue adds a zero base, which leaves every value as it is).
template <int R>
struct Tc {
  using Epi = HeadEpilogue<R>;  // K2's; unused by K1
  static constexpr int COUT = R == 0 ? CIN : 3 * R * R;
  static constexpr int N = (COUT + 7) / 8 * 8;
  static constexpr int W_BYTES = 9 * CIN * N * 2;
  // staged output of one warpgroup's row: 64 x 64 bf16, or R rows of
  // 64R x 3 u8; then the row's u8 input pixels (K2)
  static constexpr int STAGE = R == 0 ? TW * CIN * 2 : Epi::STAGE;
  static constexpr int ORIG = R == 0 ? 0 : Epi::ORIG;
  static constexpr size_t OFF_W = 2 * HALO_BYTES;
  static constexpr size_t OFF_STAGE = OFF_W + W_BYTES;
  static constexpr size_t OFF_ORIG = OFF_STAGE + TH * STAGE;
  static constexpr size_t OFF_PAR = OFF_ORIG + TH * ORIG;  // bias, alpha
  static constexpr size_t OFF_BAR = OFF_PAR + 2 * N * sizeof(float);
  static constexpr size_t SMEM = OFF_BAR + 2 * sizeof(uint64_t);
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

// Issue the 36 wgmma steps of one warpgroup's row, asynchronously (see
// wait_mma): `a_row` is halo pixel (row, 0), and tap (dy, dx) starts
// dy * (TW + 2) + dx pixels later; k16 step kc is 32 B into each row.
template <int N>
__device__ __forceinline__ void issue_mma(float (&acc)[N / 2], uint32_t a_row,
                                          uint32_t w) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
    for (int kc = 0; kc < CIN / 16; ++kc) {
      const uint32_t a =
          a_row + ((tap / 3) * (TW + 2) + tap % 3) * CIN * 2 + kc * 32;
      const uint32_t b = w + (tap * 8 + 2 * kc) * N * 16;
      Wgmma<N>::mma(acc, desc_sw128(a), desc(b, N * 16));
    }
  }
  wgmma_commit();
}

// Wait for the warpgroup's wgmmas: `acc` is final only after this.
template <int N>
__device__ __forceinline__ void wait_mma(float (&acc)[N / 2]) {
  wgmma_wait<0>();
  fence_regs(acc);  // keep every read of the accumulators below the wait
}

template <int R>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_tc_kernel(const __grid_constant__ CUtensorMap map,
                  const bf16* __restrict__ w,
                  const float* __restrict__ bias,
                  const float* __restrict__ alpha,
                  const uint8_t* __restrict__ orig, void* __restrict__ out,
                  int B, int H, int W) {
  using C = Tc<R>;
  using Epi = typename C::Epi;
  constexpr int N = C::N, COUT = C::COUT;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;  // warpgroup = tile row

  // weights, HWIO (k = tap * 64 + ci, n = co) -> [k / 8][n][8], n >= COUT 0
  bf16* ws = reinterpret_cast<bf16*>(smem + C::OFF_W);
  for (int i = tid; i < 9 * CIN * N; i += THREADS) {
    const int k = i / N, n = i - k * N;
    ws[((k >> 3) * N + n) * 8 + (k & 7)] =
        n < COUT ? w[k * COUT + n] : __float2bfloat16_rn(0.f);
  }
  float* bs = reinterpret_cast<float*>(smem + C::OFF_PAR);
  float* as = bs + N;
  for (int i = tid; i < N; i += THREADS) {
    bs[i] = i < COUT ? bias[i] : 0.f;
    if constexpr (R == 0) as[i] = alpha[i];
  }
  const uint32_t bar = base + (uint32_t)C::OFF_BAR;  // one per buffer
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
  for (int it = 0; tile < g.count; tile += gridDim.x, ++it) {
    // this tile's halo has landed (the buffer's use it / 2), and every
    // warpgroup is done with the other buffer and with the staging areas
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
    float acc[N / 2];
    issue_mma<N>(acc, base + (it & 1) * HALO_BYTES + wg * (TW + 2) * CIN * 2,
                 base + (uint32_t)C::OFF_W);
    // K2 reads the row's u8 input pixels, two bytes a thread, while the
    // tensor cores work
    const int valid = min(TW, W - x0);  // pixels of this row in the frame
    uint8_t o0 = 0, o1 = 0;
    if constexpr (R > 1)
      Epi::load_orig(orig, b, oy, x0, H, W, valid, t, o0, o1);
    wait_mma<N>(acc);

    // accumulator fragment: register 4j + 2h + e holds pixel
    // 16 * warp + lane / 4 + 8h, channel 8j + 2 * (lane % 4) + e
    const int lane = t & 31;
    const int p0 = (t >> 5) * 16 + (lane >> 2), c0 = (lane & 3) * 2;
    unsigned char* st = smem + C::OFF_STAGE + wg * C::STAGE;
    if constexpr (R == 0) {
      // (acc + b) in float32, cast to bf16; PReLU in bf16:
      // max(v, 0) + bf16(alpha * min(v, 0))
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + 8 * h, c = 8 * j + c0;
          __nv_bfloat162 v;
          float f = round_to<bf16>(__fadd_rn(acc[4 * j + 2 * h], bs[c]));
          v.x = __float2bfloat16_rn(f > 0.f ? f : __fmul_rn(as[c], f));
          f = round_to<bf16>(__fadd_rn(acc[4 * j + 2 * h + 1], bs[c + 1]));
          v.y = __float2bfloat16_rn(f > 0.f ? f : __fmul_rn(as[c + 1], f));
          *reinterpret_cast<__nv_bfloat162*>(
              st + p * 128 + ((j ^ (p & 7)) << 4) + c0 * 2) = v;
        }
      warpgroup_sync(wg);
      if (oy < H) {
        bf16* y = static_cast<bf16*>(out) + ((long long)b * H + oy) * W * CIN;
        for (int q = t; q < TW * 8; q += 128) {
          const int p = q >> 3, c = q & 7;
          if (x0 + p < W)
            *reinterpret_cast<uint4*>(y + (long long)(x0 + p) * CIN + c * 8) =
                *reinterpret_cast<const uint4*>(st + p * 128 +
                                                ((c ^ (p & 7)) << 4));
        }
      }
    } else {
      // conv + b in float32, cast to bf16, then the residual
      Epi::template row<N>(
          st, smem + C::OFF_ORIG + wg * C::ORIG, static_cast<uint8_t*>(out),
          b, oy, x0, H, W, valid, wg, t, o0, o1, [&](int q, int kk) {
            return round_to<bf16>(__fadd_rn(acc[q], bs[kk]));
          });
    }
  }
}

// The tensor map of the (B, H, W, 64) bf16 input: halo boxes, 128-B
// swizzle, zeros outside the tensor.
cudaError_t make_map(CUtensorMap* map, const void* x, int B, int H, int W) {
  return halo_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, B, H, W,
                  TW + 2, TH + 2, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int R>
cudaError_t launch(const void* x, const void* w, const float* b,
                   const float* alpha, const uint8_t* orig, void* out, int B,
                   int H, int W, cudaStream_t stream) {
  const long long tiles =
      (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  CUtensorMap map;
  cudaError_t err = make_map(&map, x, B, H, W);
  if (err != cudaSuccess) return err;
  auto kernel = conv3x3_tc_kernel<R>;
  int grid = 0;
  err = reve::persistent_grid(kernel, THREADS, Tc<R>::SMEM, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, Tc<R>::SMEM, stream>>>(
      map, static_cast<const bf16*>(w), b, alpha, orig, out, B, H, W);
  return cudaGetLastError();
}

}  // namespace

// K1 in bfloat16 (float32 is conv3x3_f32_tc.cu's).  Returns a cudaError_t
// (0 = success).
extern "C" int reve_conv3x3_bias_prelu_tc(const void* x, const void* w,
                                          const float* b, const float* alpha,
                                          void* y, int B, int H, int W,
                                          void* stream) {
  return (int)launch<0>(x, w, b, alpha, nullptr, y, B, H, W,
                        static_cast<cudaStream_t>(stream));
}

// K2 in bfloat16 (float32 is conv3x3_f32_tc.cu's); r in {2, 3, 4}.
extern "C" int reve_head_conv_residual_u8_shuffle_tc(
    const void* x, const void* w, const float* b, const uint8_t* orig,
    uint8_t* out, int B, int H, int W, int r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 2: return (int)launch<2>(x, w, b, nullptr, orig, out, B, H, W, s);
    case 3: return (int)launch<3>(x, w, b, nullptr, orig, out, B, H, W, s);
    case 4: return (int)launch<4>(x, w, b, nullptr, orig, out, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K2's conv_last mode in bfloat16 (float32 is conv3x3_f32_tc.cu's): the
// 64 -> 3 conv + b, cast to bf16, to u8 with no residual, (B, H, W, 3).
extern "C" int reve_conv_last_u8_tc(const void* x, const void* w,
                                    const float* b, uint8_t* out, int B,
                                    int H, int W, void* stream) {
  return (int)launch<1>(x, w, b, nullptr, nullptr, out, B, H, W,
                        static_cast<cudaStream_t>(stream));
}

// K1 in bfloat16 at feat = 32, 96 or 128 channels (64 is the kernel
// above): conv3x3_wide.cuh's units of 32 input channels.  `x`: (B, H, W,
// feat) bf16; `w`: the HWIO weights packed by kernels/conv3x3.py
// pack_weights_wide.  Returns a cudaError_t (0 = success).
extern "C" int reve_conv3x3_bias_prelu_wide_tc(
    const void* x, const void* w, const float* b, const float* alpha,
    void* y, int B, int H, int W, int feat, void* stream) {
  return (int)reve::wide::k1<1>(x, w, b, alpha, y, B, H, W, feat,
                                static_cast<cudaStream_t>(stream));
}

// K2 in bfloat16 at feat = 32, 96 or 128 input channels, r in {2, 3, 4}:
// the weights packed as K1's at these widths, n padded with zeros to 3r^2
// rounded up to a multiple of 8; `b`: 3r^2 float32.  Returns a
// cudaError_t (0 = success).
extern "C" int reve_head_conv_residual_u8_shuffle_wide_tc(
    const void* x, const void* w, const float* b, const uint8_t* orig,
    uint8_t* out, int B, int H, int W, int feat, int r, void* stream) {
  return (int)reve::wide::k2<1>(x, w, b, orig, out, B, H, W, feat, r,
                                static_cast<cudaStream_t>(stream));
}
