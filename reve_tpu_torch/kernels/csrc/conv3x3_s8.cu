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
// Design: conv3x3_tc.cu's persistent implicit GEMM on s8 wgmma
// (m64n64k32, s32 accumulators in registers): 9 taps x 2 k32 steps = 18
// wgmmas per 64-pixel row.  Integer accumulation is exact, so the kernel
// is bit-exact against its plain version.
//  * Blocks of 2 warpgroups walk tiles of 2 rows x 64 pixels, one row per
//    warpgroup, two blocks on each SM (80 KB of shared memory each): the
//    epilogue, on the CUDA cores, takes longer than the wgmmas, and one
//    block's epilogue runs while the other block's wgmmas do (10% faster
//    than one block of 4 warpgroups on an H100 SXM; three blocks of one
//    warpgroup were slower).  The weights (36,864 B, packed by
//    the wrapper as B K-major [k / 16][n][16]: core matrices of 8 rows x
//    16 B, no swizzle) are resident per block.
//  * The halo ((2+2) x (64+2) pixels x 64 B) comes in by one TMA copy per
//    tile into one of two buffers, so the next tile's halo loads while
//    this tile computes.  The tensor map's type is UINT8 (there is no s8
//    type; bytes are bytes), and its zero fill outside the frame is s8
//    zero, SAME padding.  A pixel is a 64-B row of the A operand, in the
//    64-B swizzle (groups of 8 rows 512 B apart); tap (dy, dx) starts
//    dy * 66 + dx rows later, base offset 0 (see tc.cuh).
//  * The epilogue rounds exactly where the reference does: __fmul_rn and
//    __fadd_rn keep nvcc from contracting the dequant into an FMA, and the
//    quantize rounds half to even (reve::quant_s8's function, as one
//    saturating conversion).  Each thread keeps its 16 channels' scale,
//    bias and alpha in registers.  Each row's 64 x 64 s8 outputs are
//    staged in shared memory (16-B chunks XOR-swizzled by pixel) and
//    written as 16-B vectors, one contiguous 4 KB run per row.  The
//    epilogue is the larger part of the kernel's time (perf_conv_tc_parts
//    on an H100 SXM); keeping the parameters in registers and quantizing
//    in one conversion took a fifth off the kernel's time.
#include "tc.cuh"

namespace {

using namespace reve::tc;

constexpr int C = 64;   // channels in and out: one s8 pixel is 64 B
constexpr int TH = 2;   // tile rows, one warpgroup each
constexpr int TW = 64;  // tile columns: the M of one wgmma
constexpr int THREADS = 128 * TH;
constexpr int HALO_TX = (TH + 2) * (TW + 2) * C;  // bytes of one copy
constexpr int HALO_BYTES = (HALO_TX + 1023) / 1024 * 1024;  // 1024-B aligned
constexpr int W_BYTES = 9 * C * C;
constexpr int STAGE = TW * C;  // one warpgroup's s8 output row
constexpr size_t OFF_W = 2 * HALO_BYTES;
constexpr size_t OFF_STAGE = OFF_W + W_BYTES;
constexpr size_t OFF_PAR = OFF_STAGE + TH * STAGE;  // scale, bias, alpha
constexpr size_t OFF_BAR = OFF_PAR + 3 * C * sizeof(float);
constexpr size_t SMEM = OFF_BAR + 2 * sizeof(uint64_t);
using Grid = TileGrid<TH, TW>;

// reve::quant_s8 as a saturating conversion: clip(rint(v), -127, 127) ==
// rint(max(v, -127)) saturated to s8 (rint is monotone and +-127 are
// integers), one conversion in place of rint, two clamps and a cast.
__device__ __forceinline__ uint32_t quant_s8_sat(float x, float inv) {
  unsigned short r;
  asm("cvt.rni.sat.s8.f32 %0, %1;"
      : "=h"(r)
      : "f"(fmaxf(__fmul_rn(x, inv), -127.f)));
  return r & 0xFFu;
}

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
__device__ __forceinline__ void issue_mma(int (&acc)[32], uint32_t a_row,
                                          uint32_t w) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
    for (int kc = 0; kc < C / 32; ++kc) {
      const uint32_t a =
          a_row + ((tap / 3) * (TW + 2) + tap % 3) * C + kc * 32;
      const uint32_t b = w + (tap * 4 + 2 * kc) * C * 16;
      wgmma_s8(acc, desc_sw64(a), desc(b, C * 16));
    }
  }
  wgmma_commit();
}

// Wait for the warpgroup's wgmmas: `acc` is final only after this.
__device__ __forceinline__ void wait_mma(int (&acc)[32]) {
  wgmma_wait<0>();
  fence_regs(acc);  // keep every read of the accumulators below the wait
}

__global__ void __launch_bounds__(THREADS, 2)
conv3x3_s8_tc_kernel(const __grid_constant__ CUtensorMap map,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const float* __restrict__ alpha,
                     const float* __restrict__ inv_next,
                     int8_t* __restrict__ y, int B, int H, int W) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;  // warpgroup = tile row

  // the packed weights, as they are
  const uint4* wsrc = reinterpret_cast<const uint4*>(w);
  uint4* ws = reinterpret_cast<uint4*>(smem + OFF_W);
  for (int i = tid; i < W_BYTES / 16; i += THREADS) ws[i] = wsrc[i];
  float* ss = reinterpret_cast<float*>(smem + OFF_PAR);
  float* bs = ss + C;
  float* as = bs + C;
  for (int i = tid; i < C; i += THREADS) {
    ss[i] = scale[i];
    bs[i] = bias[i];
    as[i] = alpha[i];
  }
  const float inv = *inv_next;
  const uint32_t bar = base + (uint32_t)OFF_BAR;  // one per buffer
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
  // this thread's 16 channels (8j + c0 + e) of scale, bias and alpha
  float sc[16], bi[16], al[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[2 * j + e] = ss[8 * j + c0 + e];
      bi[2 * j + e] = bs[8 * j + c0 + e];
      al[2 * j + e] = as[8 * j + c0 + e];
    }
  unsigned char* st = smem + OFF_STAGE + wg * STAGE;
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
    int acc[32];
    issue_mma(acc, base + (it & 1) * HALO_BYTES + wg * (TW + 2) * C,
              base + (uint32_t)OFF_W);
    wait_mma(acc);

    // accumulator fragment: register 4j + 2h + e holds pixel
    // 16 * warp + lane / 4 + 8h, channel 8j + 2 * (lane % 4) + e.  Pixel
    // p's 16-B chunk q is staged at chunk q ^ ((p / 2) % 4).
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
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
          two |= quant_s8_sat(pr, inv) << (8 * e);
        }
        *reinterpret_cast<uint16_t*>(
            st + p * C + (((c >> 4) ^ ((p >> 1) & 3)) << 4) + (c & 15)) =
            (uint16_t)two;
      }
    warpgroup_sync(wg);
    if (oy < H) {
      int8_t* yr = y + ((long long)b * H + oy) * W * C;
      for (int q = t; q < TW * (C / 16); q += 128) {
        const int p = q >> 2, ch = q & 3;
        if (x0 + p < W)
          *reinterpret_cast<uint4*>(yr + (long long)(x0 + p) * C + ch * 16) =
              *reinterpret_cast<const uint4*>(
                  st + p * C + ((ch ^ ((p >> 1) & 3)) << 4));
      }
    }
  }
}

}  // namespace

// `wp`: the weights packed by the wrapper as [k / 16][n][16] s8 (k = tap *
// 64 + ci, n = co).  Returns a cudaError_t (0 = success).
extern "C" int reve_conv3x3_s8_dq_prelu_q8(const void* x, const void* wp,
                                           const float* scale,
                                           const float* bias,
                                           const float* alpha,
                                           const float* inv_next, void* y,
                                           int B, int H, int W,
                                           void* stream) {
  const long long tiles =
      (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return (int)cudaSuccess;
  CUtensorMap map;
  cudaError_t err = halo_map(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, B, H,
                             W, TW + 2, TH + 2, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return (int)err;
  int grid = 0;
  err = reve::persistent_grid(conv3x3_s8_tc_kernel, THREADS, SMEM, tiles,
                              &grid);
  if (err != cudaSuccess) return (int)err;
  conv3x3_s8_tc_kernel<<<grid, THREADS, SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const int8_t*>(wp), scale, bias, alpha, inv_next,
      static_cast<int8_t*>(y), B, H, W);
  return (int)cudaGetLastError();
}
