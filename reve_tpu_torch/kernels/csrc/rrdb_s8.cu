// K7q dense_conv_s8: RRDBNet's dense-block conv in the int8 trunk, on s8
// wgmma.
//
// Replaces (TPU side) the s8 convs of reve_tpu/models/rrdb.py:apply_int8
// with the float32 steps that follow each, which XLA fused into one s8
// conv graph on the MXU:
//   _rdb_int8 (:247-265): conv i of a dense block, s8 x s8 -> s32, over
//       the concat of the block's quantized input and the i quantized
//       growth slices so far; _dq (:240-244), float32(y32) * sw + b (sw
//       alone: weights/quantize.py folds each concat part's activation
//       scale into its weight slice); convs 1-4 then _lrelu and the
//       quantize of the next slice, conv 5 then h * 0.2 + x_f;
//   apply_int8 (:315-327): out * 0.2 + b_in after the third dense block,
//       the quantize of the trunk output, conv_body and feat + dq.
//
// What it computes.  Over an s8 NHWC buffer of Cs channels a pixel (192 =
// nf + 4 gc in the model) it reads channels [0, Cin), Cin in {64, 96,
// 128, 160, 192}, convolves them with 3x3 s8 HWIO weights to Cout (32 or
// 64) s32 channels, dq = float32(acc) * sw[c] + b[c], and applies one
// epilogue, every step a float32 op rounded on its own (__fmul_rn,
// __fadd_rn: no FMA contraction), quant(v) = clip(rint(v * inv), +-127)
// half to even (reve::quant_s8; inv = float32(1 / s_next), formed by the
// wrapper as the reference forms it):
//   LRELU_Q  quant(where(dq >= 0, dq, dq * 0.2))  -> out8 (the growth
//            slice beside the channels read, in the same buffer)
//   RDB      z = dq * 0.2 + res (float32)  -> out; quant(z) -> out8 (the
//            first 64 channels of the other s8 buffer)
//   RRDB     z2 = (dq * 0.2 + res) * 0.2 + res2 -> out (res2's buffer,
//            in place: read and written at one pixel by one thread);
//            quant(z2) -> out8
//   ADD      dtype(float32(res) + dq) -> out (feat, in place; float32 or
//            bfloat16)
// Conv 5's quant uses the next statistic's scale (the next dense block's
// input, or conv_body's), so no quant pass runs inside the trunk.
// Accumulator headroom: 9 x 192 x 127^2 < 2^25 < 2^31; float32(acc) rounds
// to nearest even above 2^24, as the reference's astype does.
//
// Bound on an H100 SXM (3.35 TB/s, 1979 TOP/s s8 dense) per call of 4
// 1080p frames (8.29 M pixels), bytes for every form: LRELU_Q at Cin c
// reads c and writes 32 B a pixel (0.238 ms at 64 to 0.475 at 160); RDB
// reads 192 s8 + 256 float32 and writes 256 + 64 (768 B, 1.90 ms, against
// 1.83 TOP -> 0.93 ms); RRDB also reads b_in (1,024 B, 2.54 ms); ADD 320 B
// (0.79 ms).  The 346 launches of a model call: about 245 ms.
//
// Design.  K7's persistent producer/consumer layout (rrdb.cu) on K4's s8
// operand layout (conv3x3_s8.cu): an implicit GEMM with M = 64 pixels of a
// row, N = Cout, K = 9 taps x Cin, on wgmma m64nNk32 with s32
// accumulators in registers.
//  * Cin is walked in chunks of 64 channels, not 32: a 64-channel s8
//    pixel is one 64-B row of the A operand in the 64-B swizzle, exactly
//    K4's halo (tap (dy, dx) starts dy * 66 + dx rows later, k32 step kc
//    32 B into the row), so the proven layout carries over.  Cin = 96 and
//    160 end in a half chunk: the tensor map's channel count is Cin, so
//    TMA fills channels Cin..63 of the last box with zeros (never reading
//    the growth slices that later convs write there), and the packed
//    weights hold zeros for them.  The wasted products (a third at 96, a
//    fifth at 160) cost nothing that shows: every form is bound by bytes.
//  * Persistent blocks of 4 consumer warpgroups (one tile row of 64
//    pixels each, tiles of 4 x 64) and one producer warp.  The weights of
//    all chunks (at most 3 x 9 x 64 x 64 = 110,592 B) come in once per
//    block by one bulk copy and stay resident; each chunk's halo, (4+2) x
//    (64+2) pixels x 64 B, is one TMA box of a 4-D map over the Cin
//    channels of the Cs-byte pixels, through a ring of three stages.
//    The warpgroups release a stage with a predicated arrival after the
//    wgmmas that read it are waited on, so no branch on the thread index
//    sits between a wgmma and its wait.
//  * The epilogue runs on the accumulator fragment after the last chunk:
//    each thread holds 2 pixels x N / 4 channels and reads and writes them
//    as pairs (2 B of s8, 8 B of float32, 4 B of bf16).  A simple
//    epilogue; staging its stores through shared memory is later work.
#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace reve::tc;

constexpr int CK = 64;   // input channels per chunk: one 64-B A row
constexpr int TH = 4;    // tile rows, one warpgroup each
constexpr int TW = 64;   // tile columns: the M of one wgmma
constexpr int THREADS = 128 * TH + 32;  // + the producer warp
constexpr int HALO_TX = (TH + 2) * (TW + 2) * CK;  // bytes of one box
constexpr int HALO_BYTES = (HALO_TX + 1023) / 1024 * 1024;  // 1024-B aligned
constexpr int HS = 3;          // halo stages
constexpr int MAX_CHUNKS = 3;  // Cin <= 192
using Grid = TileGrid<TH, TW>;

enum Epilogue { LRELU_Q = 0, RDB = 1, RRDB = 2, ADD = 3 };

template <int N>
struct K7q {
  static constexpr int CHUNK_W = 9 * CK * N;  // one chunk's packed weights
  static constexpr size_t OFF_W = (size_t)HS * HALO_BYTES;
  static constexpr size_t OFF_BAR = OFF_W + (size_t)MAX_CHUNKS * CHUNK_W;
  // barriers: HS halo full, HS halo empty, the weights
  static constexpr size_t SMEM = OFF_BAR + (2 * HS + 1) * sizeof(uint64_t);
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

template <int N>
__global__ void __launch_bounds__(THREADS, 1)
dense_conv_s8_kernel(const __grid_constant__ CUtensorMap map,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ sw,
                     const float* __restrict__ bias,
                     const float* __restrict__ inv_next, const void* res,
                     const void* res2, void* out, int8_t* out8, int out8_px,
                     int epi, int feat_bf16, int chunks, int B, int H,
                     int W) {
  using K = K7q<N>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;  // warpgroup = tile row
  const uint32_t halo_full = base + (uint32_t)K::OFF_BAR;
  const uint32_t halo_empty = halo_full + 8 * HS;
  const uint32_t w_full = halo_empty + 8 * HS;
  if (tid == 0) {
    for (int s = 0; s < HS; ++s) {
      mbar_init(halo_full + 8 * s, 1);
      mbar_init(halo_empty + 8 * s, TH);
    }
    mbar_init(w_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Grid g(B, H, W);

  if (wg == TH) {
    // The producer warp: one thread copies the weights once, then every
    // chunk's halo in the order the warpgroups consume them.  The gh-th
    // halo of the block waits for the warpgroups to release the one HS
    // before it.
    if (t != 0) return;
    const uint32_t wbytes = (uint32_t)chunks * K::CHUNK_W;
    mbar_expect_tx(w_full, wbytes);
    bulk_load(base + (uint32_t)K::OFF_W, w, wbytes, w_full);
    long long gh = 0;
    for (long long tile = blockIdx.x; tile < g.count; tile += gridDim.x) {
      int b, y0, x0;
      g.origin(tile, b, y0, x0);
      for (int c = 0; c < chunks; ++c, ++gh) {
        const int hs = (int)(gh % HS);
        if (gh >= HS)
          mbar_wait(halo_empty + 8 * hs, (uint32_t)((gh / HS - 1) & 1));
        mbar_expect_tx(halo_full + 8 * hs, HALO_TX);
        tma_load_4d(base + hs * HALO_BYTES, &map, halo_full + 8 * hs,
                    c * CK, x0 - 1, y0 - 1, b);
      }
    }
    return;
  }

  const int lane = t & 31;
  const int p0 = (t >> 5) * 16 + (lane >> 2), c0 = (lane & 3) * 2;
  // this thread's N / 4 channels (8j + c0 + e) of sw and b
  float sc[N / 4], bi[N / 4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[2 * j + e] = sw[8 * j + c0 + e];
      bi[2 * j + e] = bias[8 * j + c0 + e];
    }
  const float inv = epi == ADD ? 0.f : *inv_next;
  const float k02 = 0.2f;  // float32(0.2), as the reference's weak 0.2
  const uint32_t row_off = wg * (TW + 2) * CK;  // the row's halo pixels
  const uint32_t wsm = base + (uint32_t)K::OFF_W;
  mbar_wait(w_full, 0);
  long long gh = 0;
  for (long long tile = blockIdx.x; tile < g.count; tile += gridDim.x) {
    int b, y0, x0;
    g.origin(tile, b, y0, x0);
    int acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0;
    for (int c = 0; c < chunks; ++c, ++gh) {
      const int hs = (int)(gh % HS);
      mbar_wait(halo_full + 8 * hs, (uint32_t)((gh / HS) & 1));
      const uint32_t a_row = base + hs * HALO_BYTES + row_off;
      const uint32_t wc = wsm + c * K::CHUNK_W;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int kc = 0; kc < CK / 32; ++kc) {
          const uint32_t a =
              a_row + ((tap / 3) * (TW + 2) + tap % 3) * CK + kc * 32;
          const uint32_t bw = wc + (tap * 4 + 2 * kc) * N * 16;
          WgmmaS8<N>::mma(acc, desc_sw64(a), desc(bw, N * 16));
        }
      wgmma_commit();
      fence_regs(acc);
      // the chunk before this one is done: release its halo
      wgmma_wait<1>();
      mbar_arrive_if(halo_empty + 8 * (int)((gh + HS - 1) % HS),
                     c > 0 && t == 0);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive_if(halo_empty + 8 * (int)((gh - 1) % HS), t == 0);

    // accumulator fragment: register 4j + 2h + e holds pixel
    // 16 * warp + lane / 4 + 8h, channel 8j + 2 * (lane % 4) + e
    const int oy = y0 + wg;
    if (oy >= H) continue;
    const long long row = ((long long)b * H + oy) * W;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = x0 + p0 + 8 * h;
        if (x >= W) continue;
        const int c = 8 * j + c0;
        const long long pix = row + x;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]),
                                     sc[2 * j + e]),
                           bi[2 * j + e]);
        if (epi == ADD) {
          const long long o = pix * N + c;
          if (feat_bf16) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    static_cast<const bf16*>(res) + o));
            __nv_bfloat162 r;
            r.x = __float2bfloat16_rn(__fadd_rn(f.x, v[0]));
            r.y = __float2bfloat16_rn(__fadd_rn(f.y, v[1]));
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + o) =
                r;
          } else {
            const float2 f = *reinterpret_cast<const float2*>(
                static_cast<const float*>(res) + o);
            *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
                make_float2(__fadd_rn(f.x, v[0]), __fadd_rn(f.y, v[1]));
          }
          continue;
        }
        if (epi == LRELU_Q) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = v[e] >= 0.f ? v[e] : __fmul_rn(v[e], k02);
        } else {
          const long long o = pix * N + c;
          const float2 x2 = *reinterpret_cast<const float2*>(
              static_cast<const float*>(res) + o);
          v[0] = __fadd_rn(__fmul_rn(v[0], k02), x2.x);
          v[1] = __fadd_rn(__fmul_rn(v[1], k02), x2.y);
          if (epi == RRDB) {
            const float2 r2 = *reinterpret_cast<const float2*>(
                static_cast<const float*>(res2) + o);
            v[0] = __fadd_rn(__fmul_rn(v[0], k02), r2.x);
            v[1] = __fadd_rn(__fmul_rn(v[1], k02), r2.y);
          }
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
              make_float2(v[0], v[1]);
        }
        *reinterpret_cast<uint16_t*>(out8 + pix * out8_px + c) =
            (uint16_t)(reve::quant_s8(v[0], inv) |
                       (reve::quant_s8(v[1], inv) << 8));
      }
  }
}

template <int N>
cudaError_t launch(const void* x, const void* wp, const float* sw,
                   const float* b, const float* inv, const void* res,
                   const void* res2, void* out, void* out8, int B, int H,
                   int W, int cin, int cs, int out8_px, int epi,
                   int feat_bf16, cudaStream_t stream) {
  if (cin <= 0 || cin % 32 || cin > cs || cin > MAX_CHUNKS * CK ||
      epi < LRELU_Q || epi > ADD)
    return cudaErrorInvalidValue;
  if ((epi != ADD && (out8 == nullptr || inv == nullptr)) ||
      (epi != LRELU_Q && (res == nullptr || out == nullptr)) ||
      (epi == RRDB && res2 == nullptr))
    return cudaErrorInvalidValue;
  const long long tiles =
      (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  // the first Cin channels of the Cs-byte pixels; a box past Cin reads
  // zeros
  CUtensorMap map;
  cudaError_t err = halo_map(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, B,
                             H, W, TW + 2, TH + 2, CU_TENSOR_MAP_SWIZZLE_64B,
                             CK, cin, cs);
  if (err != cudaSuccess) return err;
  auto kernel = dense_conv_s8_kernel<N>;
  int grid = 0;
  err = reve::persistent_grid(kernel, THREADS, K7q<N>::SMEM, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, K7q<N>::SMEM, stream>>>(
      map, static_cast<const int8_t*>(wp), sw, b, inv, res, res2, out,
      static_cast<int8_t*>(out8), out8_px, epi, feat_bf16,
      (cin + CK - 1) / CK, B, H, W);
  return cudaGetLastError();
}

}  // namespace

// K7q: `x` the (B, H, W, cs) s8 buffer, of which the conv reads channels
// [0, cin); `wp` the weights packed as [cin / 64 rounded up][tap][k / 16]
// [n][16] s8, zeros past cin; `sw`, `b` cout float32 each; `inv` one
// float32, 1 / s_next (unused by ADD); `res`, `res2`, `out` (B, H, W,
// cout) float32 (ADD: res and out float32, or bfloat16 when feat_bf16);
// `out8` the first of the cout s8 channels it writes, pixels out8_px
// bytes apart (unused by ADD); `epi` 0 LRELU_Q, 1 RDB, 2 RRDB, 3 ADD.
// Returns a cudaError_t.
extern "C" int reve_dense_conv_s8(const void* x, const void* wp,
                                  const float* sw, const float* b,
                                  const float* inv, const void* res,
                                  const void* res2, void* out, void* out8,
                                  int B, int H, int W, int cin, int cs,
                                  int cout, int out8_px, int epi,
                                  int feat_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 32:
      return (int)launch<32>(x, wp, sw, b, inv, res, res2, out, out8, B, H,
                             W, cin, cs, out8_px, epi, feat_bf16, s);
    case 64:
      return (int)launch<64>(x, wp, sw, b, inv, res, res2, out, out8, B, H,
                             W, cin, cs, out8_px, epi, feat_bf16, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
