// float32 conv_last: RRDBNet's last conv, 64 -> 3 + b in float32, to u8
// with no residual, on the CUDA cores in float32.
//
// Replaces (TPU side): reve_tpu/models/rrdb.py:232-234, conv_last of apply
// at float32 (Precision.HIGHEST: float32 accumulation, + b in float32, no
// cast), with the engine's u8 rounding (reve_tpu/pipeline/engine.py:428-
// 429): u8(clip(y * 255 + 0.5, 0, 255)), truncated.  On the port it takes
// the place of K2's conv_last mode in float32 (the split pass, then K2's
// bf16x6 head at r = 1, conv3x3_f32_tc.cu), which read its input, wrote
// three bf16 planes, read those back in halos and ran 216 m64n8k16 wgmmas
// a 64-pixel row, each reading its 2-KB A tile from shared memory.
//
// Bound on an H100 SXM per call of 2 frames of 7680 x 4320 (the float32
// RRDB plan's chunk, 66.4 M pixels): 16.99 GB of float32 in + 0.20 GB of
// u8 out -> 5.13 ms (bytes); 2 x 9 x 64 x 3 = 3,456 float32 operations a
// pixel, 229 GFLOP -> 3.42 ms at 67 TFLOP/s.  The function is bound by
// reading its input once.  On an "NVIDIA H100 80GB HBM3, 700.00 W" a call
// takes 6.9 ms: its loads alone 5.5, its FMAs alone 6.6, at about half
// the card's float32 rate (PERF.md §6).
//
// Design.
//  * No split pass: the input is read once, as float32, and every product
//    is a float32 fmaf (the sum differs from cuDNN's float32 conv only in
//    its order: u8 |d| <= 1 where y * 255 + 0.5 sits at an integer).
//  * The 1,728 FMAs a pixel cost 6.9 KB of shared-memory operand reads a
//    pixel on wgmma at N = 8 (their reads, not the tensor cores' math,
//    set the old kernel's pace); here a thread takes 8 neighbouring
//    pixels of one row and 4 channels of each 32-channel half, so each
//    16-B load of 4 channels of a pixel serves the three horizontal taps
//    (10 loads for 8 pixels), and each 16-B weight load (4 channels, one
//    tap, one output channel) serves 8 pixels.  The 8 lanes that share a
//    pixel group hold partial sums of 8 channels; three shuffle rounds
//    reduce and scatter them, so lane q ends with pixel q's 3 outputs.
//  * Rows in by TMA, each read once per strip: a block walks work items
//    of 64 columns x 64 rows (a strip segment) down the rows, 4 output
//    rows a step, through a ring of 12 input-row slots (64 + 2 pixels x
//    64 channels, 16,896 B each).  One producer thread loads each row
//    once into the ring (the frame's SAME padding at its left and right
//    edges from TMA's zero fill; rows above and below the frame are not
//    loaded: their taps read a row of zeros), so an input row is read 1.03x
//    (its 2 halo columns) and 2 rows of 64 again per segment; the grid is
//    persistent, so the next rows load while these are summed.
//  * Weights and bias stay in shared memory, packed by each block from
//    the HWIO weights in the order the lanes read them.
//  * The epilogue: y = conv + b in float32, then the u8 rounding, each
//    lane writing its pixel's 3 bytes.
#include "tc.cuh"

namespace {

using namespace reve::tc;

constexpr int CIN = 64, COUT = 3;
constexpr int TW = 64;                 // strip width (output columns)
constexpr int ROWS = 4;                // output rows a step
constexpr int WARPS = 2 * ROWS;        // a warp: one row, half the strip
constexpr int THREADS = 32 * WARPS + 32;  // + the producer warp
constexpr int SEG = 64;                // output rows of a work item
constexpr int SLOTS = 12;              // the ring of input rows
constexpr int PX = TW + 2;             // pixels of an input row
constexpr int ROW_FLOATS = PX * CIN;
constexpr int ROW_BYTES = ROW_FLOATS * 4;  // one TMA box: 16,896 B
constexpr int P = 8;                   // output pixels a thread
// weights [half][dy][dx][c][q][4]: channel 32 half + 4 q + k
constexpr int W_FLOATS = 2 * 9 * COUT * 8 * 4;
// after the ring: a row of zeros, read in place of rows outside the frame
constexpr size_t OFF_ZERO = (size_t)SLOTS * ROW_BYTES;
constexpr size_t OFF_W = OFF_ZERO + ROW_BYTES;
constexpr size_t OFF_B = OFF_W + W_FLOATS * 4;
constexpr size_t OFF_BAR = OFF_B + 4 * 4;  // full[SLOTS], then empty
constexpr size_t SMEM = OFF_BAR + 2 * SLOTS * sizeof(uint64_t);
static_assert(SMEM <= 232448, "more shared memory than a block may have");
static_assert(ROW_BYTES % 128 == 0, "row slots 128-B aligned");
static_assert(SEG % ROWS == 0, "a segment is whole steps");

// Work items: segments of SEG output rows of TW-column strips, strips
// fastest (TileGrid's order), so the blocks at work at one time share halo
// columns in L2.
using Work = TileGrid<SEG, TW>;

// steps of ROWS output rows in the item whose first row is y0
__device__ __forceinline__ int steps_at(int y0, int H) {
  return (min(SEG, H - y0) + ROWS - 1) / ROWS;
}

// One tap row (dy) and one 32-channel half of the thread's 8 pixels:
// acc[j][c] += sum over dx and the lane's 4 channels of x[j + dx] * w[dx][c].
// `xr`: the lane's 4 channels of the first of its 10 input pixels (pixels
// CIN floats apart); `wr`: the half's and row's weights, at the lane's q.
__device__ __forceinline__ void fma_row(float (&acc)[P][COUT],
                                        const float* xr, const float* wr) {
  float4 xv[P + 2];
#pragma unroll
  for (int j = 0; j < P + 2; ++j)
    xv[j] = *reinterpret_cast<const float4*>(xr + j * CIN);
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int c = 0; c < COUT; ++c) {
      const float4 w = *reinterpret_cast<const float4*>(wr +
                                                        (dx * COUT + c) * 32);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float4 x = xv[j + dx];
        float a = acc[j][c];
        a = fmaf(x.x, w.x, a);
        a = fmaf(x.y, w.y, a);
        a = fmaf(x.z, w.z, a);
        a = fmaf(x.w, w.w, a);
        acc[j][c] = a;
      }
    }
}

__global__ void __launch_bounds__(THREADS, 1)
conv_last_f32_kernel(const __grid_constant__ CUtensorMap map,
                     const float* __restrict__ w,
                     const float* __restrict__ bias,
                     uint8_t* __restrict__ out, int B, int H, int W) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* xs = reinterpret_cast<const float*>(smem);
  const float* zero = reinterpret_cast<const float*>(smem + OFF_ZERO);
  float* ws = reinterpret_cast<float*>(smem + OFF_W);
  float* bs = reinterpret_cast<float*>(smem + OFF_B);
  // the HWIO weights in the lanes' order: i = ((((half * 3 + dy) * 3 + dx)
  // * 3 + c) * 8 + q) * 4 + k holds w[dy][dx][32 half + 4 q + k][c]
  for (int i = tid; i < W_FLOATS; i += THREADS) {
    const int k = i & 3, q = (i >> 2) & 7;
    int t = i >> 5;
    const int c = t % COUT;
    t /= COUT;
    const int dx = t % 3;
    t /= 3;
    const int dy = t % 3, half = t / 3;
    ws[i] = w[((dy * 3 + dx) * CIN + 32 * half + 4 * q + k) * COUT + c];
  }
  if (tid < COUT) bs[tid] = bias[tid];
  for (int i = tid; i < ROW_BYTES / 16; i += THREADS)
    reinterpret_cast<float4*>(smem + OFF_ZERO)[i] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  const uint32_t full = base + (uint32_t)OFF_BAR;
  const uint32_t empty = full + 8 * SLOTS;
  if (tid == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Work work(B, H, W);

  if (warp == WARPS) {
    // The producer: each item's rows y0 - 1 .. y0 + ROWS * steps, in
    // order through the ring; row g of the block's sequence waits for
    // the warps to release row g - SLOTS.  A row outside the frame is
    // not loaded: its full barrier is only arrived on.
    if (lane != 0) return;
    long long g = 0;
    for (long long item = blockIdx.x; item < work.count;
         item += gridDim.x) {
      int b, y0, x0;
      work.origin(item, b, y0, x0);
      const int steps = steps_at(y0, H);
      for (int i = 0; i < ROWS * steps + 2; ++i, ++g) {
        const int s = (int)(g % SLOTS);
        if (g >= SLOTS)
          mbar_wait(empty + 8 * s, (uint32_t)((g / SLOTS - 1) & 1));
        const int iy = y0 - 1 + i;
        if (iy >= 0 && iy < H) {
          mbar_expect_tx(full + 8 * s, ROW_BYTES);
          tma_load_4d(base + s * ROW_BYTES, &map, full + 8 * s, 0, x0 - 1,
                      iy, b);
        } else {
          mbar_arrive_if(full + 8 * s, true);
        }
      }
    }
    return;
  }

  // The consumer warps: warp = (row r of the step, half of the strip);
  // lane = (pixel group pg of 8 pixels, channel quad q).
  const int r = warp >> 1, half = warp & 1;
  const int q = lane & 7, pg = lane >> 3;
  const int px0 = half * 32 + pg * 8;  // first output pixel in the strip
  long long g0 = 0;                    // the item's first row in the ring
  for (long long item = blockIdx.x; item < work.count; item += gridDim.x) {
    int b, y0, x0;
    work.origin(item, b, y0, x0);
    const int steps = steps_at(y0, H);
    for (int st = 0; st < steps; ++st) {
      const long long gs = g0 + ROWS * st;  // the step's first input row
      // every row of the step, so that each warp sees every row's phase
      // complete before it releases the row
#pragma unroll
      for (int i = 0; i < ROWS + 2; ++i)
        mbar_wait(full + 8 * (int)((gs + i) % SLOTS),
                  (uint32_t)(((gs + i) / SLOTS) & 1));
      const int oy = y0 + ROWS * st + r;
      float acc[P][COUT];
#pragma unroll
      for (int j = 0; j < P; ++j)
#pragma unroll
        for (int c = 0; c < COUT; ++c) acc[j][c] = 0.f;
      // one block of code with no branch, so the compiler may issue a
      // tap row's loads while the last one's FMAs run; rows outside the
      // frame (SAME padding) read the row of zeros
      const float* rows[3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int iy = oy - 1 + dy;
        rows[dy] = (iy >= 0 && iy < H
                        ? xs + (int)((gs + r + dy) % SLOTS) * ROW_FLOATS
                        : zero) +
                   px0 * CIN + 4 * q;
      }
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          fma_row(acc, rows[dy] + 32 * hf,
                  ws + (hf * 3 + dy) * 9 * 32 + 4 * q);
      // release the rows no later step reads: the step's first ROWS, and
      // at the item's last step its last two as well
      const int rel = st + 1 < steps ? ROWS : ROWS + 2;
      for (int i = 0; i < rel; ++i)
        mbar_arrive_if(empty + 8 * (int)((gs + i) % SLOTS), lane == 0);

      // The epilogue: reduce the 8 lanes' partial sums of each pixel and
      // scatter them, halving the pixels a lane holds each round (lane bit
      // 4, 2, 1 picks the upper half), so lane q ends with pixel q.
      float v4[4][COUT], v2[2][COUT], v[COUT];
      const bool b2 = q & 4, b1 = q & 2, b0 = q & 1;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < COUT; ++c) {
          const float send = b2 ? acc[j][c] : acc[j + 4][c];
          const float keep = b2 ? acc[j + 4][c] : acc[j][c];
          v4[j][c] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
        }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < COUT; ++c) {
          const float send = b1 ? v4[j][c] : v4[j + 2][c];
          const float keep = b1 ? v4[j + 2][c] : v4[j][c];
          v2[j][c] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
        }
#pragma unroll
      for (int c = 0; c < COUT; ++c) {
        const float send = b0 ? v2[0][c] : v2[1][c];
        const float keep = b0 ? v2[1][c] : v2[0][c];
        v[c] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
      }
      const int x = x0 + px0 + q;
      if (oy < H && x < W) {
        uint8_t* o = out + (((long long)b * H + oy) * W + x) * COUT;
        // y = conv + b, then the u8 rounding (on a zero residual base,
        // which leaves the value as it is)
#pragma unroll
        for (int c = 0; c < COUT; ++c)
          o[c] = reve::residual_u8(__fadd_rn(v[c], bs[c]), 0.f);
      }
    }
    g0 += ROWS * steps + 2;
  }
}

}  // namespace

// float32 conv_last: x (B, H, W, 64) float32 NHWC, w (3, 3, 64, 3)
// float32 HWIO, b 3 float32 -> out (B, H, W, 3) u8, u8(clip((conv + b) *
// 255 + 0.5, 0, 255)).  x 16-B aligned.  Returns a cudaError_t (0 =
// success).
extern "C" int reve_conv_last_u8_f32(const void* x, const float* w,
                                     const float* b, uint8_t* out, int B,
                                     int H, int W, void* stream) {
  const long long items = (long long)B * ((H + SEG - 1) / SEG) *
                          ((W + TW - 1) / TW);
  if (items == 0) return (int)cudaSuccess;
  CUtensorMap map;
  cudaError_t err =
      halo_map(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, B, H, W, PX, 1,
               CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return (int)err;
  int grid = 0;
  err = reve::persistent_grid(conv_last_f32_kernel, THREADS, SMEM, items,
                              &grid);
  if (err != cudaSuccess) return (int)err;
  conv_last_f32_kernel<<<grid, THREADS, SMEM,
                         static_cast<cudaStream_t>(stream)>>>(map, w, b, out,
                                                              B, H, W);
  return (int)cudaGetLastError();
}
