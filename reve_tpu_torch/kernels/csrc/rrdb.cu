// K7 dense_conv: RRDBNet's dense-block conv, in bfloat16 and float32, on
// the tensor cores.
//
// Replaces (TPU side) the 3x3 convs of reve_tpu/models/rrdb.py's trunk
// with the elementwise step that follows each, which XLA fused into one
// conv graph (in its s2d domain, an exact reshaping for the MXU's width):
//   _rdb (:157-165): conv i of a dense block over the concat of the
//       block's input and the i growth slices so far; convs 1-4 (32
//       outputs) then _lrelu (:153-154), conv 5 (64 outputs) then
//       feats[-1] * 0.2 + x;
//   _rrdb (:168-172): after the third dense block, out * 0.2 + x;
//   apply (:229): feat + conv_body(body).
// Each conv adds its bias in float32 and casts to the compute dtype
// (_raw_conv, :86-94; float32 at Precision.HIGHEST); each step after it
// rounds to the compute dtype, in the reference's order.
//
// What it computes.  Over an NHWC buffer of Cs channels per pixel (192 =
// nf + 4 gc in the model) it reads channels [0, Cin) (Cin a multiple of
// 32), convolves them with 3x3 HWIO weights to Cout (32 or 64) channels,
// y = dtype(conv + b), and writes Cout channels of `out` (pixels out_px
// values apart) after one epilogue:
//   LRELU  where(y >= 0, y, dtype(y * dtype(0.2)))         convs 1-4
//   RDB    dtype(dtype(y * 0.2) + x)                       conv 5
//   RRDB   RDB, then dtype(dtype(. * 0.2) + r)             conv 5 of the
//                                                          third block
//   ADD    dtype(x + y)                                    conv_body
// x and r are the first Cout channels of `res` and `res2` at the same
// pixel.  Convs 1-4 write their slice of the buffer they read (channels
// the conv does not read); conv 5 writes the other buffer of its pair
// (neighbouring tiles still read its input through their halo), and the
// RRDB form writes over r, read at the same pixel by the same thread.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) per call of 4 1080p
// frames: conv 1 (Cin 64 -> 32) 1.06 GB in + 0.53 GB out -> 0.475 ms
// (bytes) against 306 GFLOP -> 0.309 ms; conv 5 (192 -> 64) 3.18 + 1.06 GB
// -> 1.27 ms against 1.83 TFLOP -> 1.855 ms (operations).  In float32 the
// bytes double and the six bf16 products make the operations six times
// as many: every form is bound by its operations.
//
// Design.  The conv is an implicit GEMM: M = 64 pixels of a row, N = Cout,
// K = 9 taps x Cin, on wgmma m64nNk16 with float32 accumulators in
// registers, like K1 (conv3x3_tc.cu).  K1 keeps all its weights and a
// whole-Cin halo resident; at Cin = 192 a halo would take 152 KB and
// conv 5's weights 221 KB, past a block's 227 KB.  So K7 walks Cin in
// chunks of 32 channels:
//  * Persistent blocks of 4 consumer warpgroups (one tile row of 64
//    pixels each, tiles of 4 x 64) and one producer warp.  A chunk's
//    halo, (4+2) x (64+2) pixels x 32 channels, is one TMA box of a 4-D
//    map over the Cin channels of the Cs-channel pixels (tc.cuh's
//    halo_map with a channel count and pixel stride); a pixel is one
//    64-B row of the A operand in the 64-B swizzle, and tap (dy, dx)
//    starts dy * 66 + dx rows later (as K4's s8 rows).  Zeros outside the
//    frame are SAME padding.
//  * Weights are packed once per model (kernels/rrdb.py,
//    pack_weights_dense) as [chunk][tap][split][k / 8][n][8] bf16 (B
//    K-major, core matrices of 8 rows x 16 B) and stream by bulk copies
//    through their own ring; the halos through another.  The producer
//    issues every copy in the order the warpgroups consume them, and the
//    warpgroups release each stage with a predicated arrival after the
//    wgmmas that read it are waited on, so no branch on the thread index
//    sits between a wgmma and its wait.
//  * bfloat16: one plane, a stage of weights per chunk (9 taps, 36,864 B
//    at Cout 64), three halo and three weight stages (187,744 B).
//  * float32: as float32 K1, six bf16 products of operands split in
//    three (hi.hi in one accumulator set, the five smaller ones in
//    another; never TF32).  The wrapper splits the Cin channels the conv
//    reads (split_bf16x3 on the channel slice) into three planes; the
//    weights' splits stream a tap at a time (12,288 B at Cout 64), with
//    two halo stages of three planes (190,656 B).
//  * The epilogue runs on the accumulator fragment after the last chunk:
//    the bias, the rounding and the residual reads and writes of each
//    thread's 2 pixels x N / 4 channels as pairs of values (4 B in bf16,
//    8 B in float32), with the reference's rounding (__fadd_rn,
//    __fmul_rn, round_to; no FMA contraction).
#include <type_traits>

#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using reve::round_to;
using namespace reve::tc;

constexpr int CK = 32;   // input channels per chunk: one 64-B A row
constexpr int TH = 4;    // tile rows, one warpgroup each
constexpr int TW = 64;   // tile columns: the M of one wgmma
constexpr int THREADS = 128 * TH + 32;  // + the producer warp
constexpr int HALO_TX = (TH + 2) * (TW + 2) * CK * 2;  // one plane's box
constexpr int HALO_BYTES = (HALO_TX + 1023) / 1024 * 1024;  // 1024-B aligned
using Grid = TileGrid<TH, TW>;

enum Epilogue { LRELU = 0, RDB = 1, RRDB = 2, ADD = 3 };

// F32 = false: bf16 operands, one plane; a weight stage holds a chunk's 9
// taps.  F32 = true: three planes (hi, mid, lo) and six products; a
// weight stage holds one tap's three splits.
template <bool F32, int N>
struct K7 {
  using T = std::conditional_t<F32, float, bf16>;
  static constexpr int PLANES = F32 ? 3 : 1;
  static constexpr int HS = F32 ? 2 : 3;   // halo stages
  static constexpr int TPS = F32 ? 1 : 9;  // taps per weight stage
  static constexpr int UNITS = 9 / TPS;    // weight stages per chunk
  static constexpr int WS = 3;             // weight stages
  static constexpr int SPLIT_BYTES = CK * N * 2;  // one tap, one split
  static constexpr int TAP_BYTES = PLANES * SPLIT_BYTES;
  static constexpr int W_STAGE = TPS * TAP_BYTES;
  static constexpr int HALO_STAGE = PLANES * HALO_BYTES;
  static constexpr size_t OFF_W = (size_t)HS * HALO_STAGE;
  static constexpr size_t OFF_PAR = OFF_W + (size_t)WS * W_STAGE;  // bias
  static constexpr size_t OFF_BAR = OFF_PAR + N * sizeof(float);
  // barriers: HS halo full, HS halo empty, WS weights full, WS empty
  static constexpr size_t SMEM =
      OFF_BAR + 2 * (HS + WS) * sizeof(uint64_t);
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

// The products of one k16 step: `a` is the (hi) plane's A operand, `w`
// the tap's (hi) weights.  bf16: one wgmma into `acc`.  float32: mid and
// lo one and two halo buffers and splits later; hi.hi into `acc`, the
// five smaller products into `cor`, smallest first.
template <bool F32, int N>
__device__ __forceinline__ void mma_step(float (&acc)[N / 2],
                                         float (&cor)[N / 2], uint32_t a,
                                         uint32_t w) {
  const uint64_t ah = desc_sw64(a), bh = desc(w, N * 16);
  if constexpr (F32) {
    constexpr int SPLIT = CK * N * 2;
    const uint64_t am = desc_sw64(a + HALO_BYTES),
                   al = desc_sw64(a + 2 * HALO_BYTES);
    const uint64_t bm = desc(w + SPLIT, N * 16),
                   bl = desc(w + 2 * SPLIT, N * 16);
    Wgmma<N>::mma(cor, al, bh);
    Wgmma<N>::mma(cor, ah, bl);
    Wgmma<N>::mma(cor, am, bm);
    Wgmma<N>::mma(cor, am, bh);
    Wgmma<N>::mma(cor, ah, bm);
  }
  Wgmma<N>::mma(acc, ah, bh);
}

template <typename T>
__device__ __forceinline__ float2 load2(const T* p);
template <>
__device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load2<bf16>(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float v0, float v1);
template <>
__device__ __forceinline__ void store2<float>(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float v0, float v1) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(v0);
  v.y = __float2bfloat16_rn(v1);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// dtype(dtype(v * s) + x): a residual step of the dense blocks
template <typename T>
__device__ __forceinline__ float scaled_add(float v, float s, float x) {
  return round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(v, s)), x));
}

template <bool F32, int N>
__global__ void __launch_bounds__(THREADS, 1)
dense_conv_kernel(const __grid_constant__ CUtensorMap map,
                  const bf16* __restrict__ w, const float* __restrict__ bias,
                  const typename K7<F32, N>::T* res, int res_px,
                  const typename K7<F32, N>::T* res2, int res2_px,
                  typename K7<F32, N>::T* out, int out_px, int epi,
                  int chunks, int B, int H, int W) {
  using K = K7<F32, N>;
  using T = typename K::T;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;  // warpgroup = tile row

  float* bs = reinterpret_cast<float*>(smem + K::OFF_PAR);
  for (int i = tid; i < N; i += THREADS) bs[i] = bias[i];
  const uint32_t halo_full = base + (uint32_t)K::OFF_BAR;
  const uint32_t halo_empty = halo_full + 8 * K::HS;
  const uint32_t w_full = halo_empty + 8 * K::HS;
  const uint32_t w_empty = w_full + 8 * K::WS;
  if (tid == 0) {
    for (int s = 0; s < K::HS; ++s) {
      mbar_init(halo_full + 8 * s, 1);
      mbar_init(halo_empty + 8 * s, TH);
    }
    for (int s = 0; s < K::WS; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, TH);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Grid g(B, H, W);

  if (wg == TH) {
    // The producer warp: one thread issues every copy in the order the
    // warpgroups consume them, each chunk's halo before its weights.  The
    // gh-th halo (gw-th weight stage) of the block waits for the
    // warpgroups to release the one HS (WS) before it.
    if (t != 0) return;
    long long gh = 0, gw = 0;
    for (long long tile = blockIdx.x; tile < g.count; tile += gridDim.x) {
      int b, y0, x0;
      g.origin(tile, b, y0, x0);
      for (int c = 0; c < chunks; ++c, ++gh) {
        const int hs = (int)(gh % K::HS);
        if (gh >= K::HS)
          mbar_wait(halo_empty + 8 * hs, (uint32_t)((gh / K::HS - 1) & 1));
        mbar_expect_tx(halo_full + 8 * hs, K::PLANES * HALO_TX);
        for (int q = 0; q < K::PLANES; ++q)
          tma_load_4d(base + hs * K::HALO_STAGE + q * HALO_BYTES, &map,
                      halo_full + 8 * hs, c * CK, x0 - 1, y0 - 1, q * B + b);
        for (int u = 0; u < K::UNITS; ++u, ++gw) {
          const int ws = (int)(gw % K::WS);
          if (gw >= K::WS)
            mbar_wait(w_empty + 8 * ws, (uint32_t)((gw / K::WS - 1) & 1));
          mbar_expect_tx(w_full + 8 * ws, K::W_STAGE);
          bulk_load(base + (uint32_t)(K::OFF_W + ws * K::W_STAGE),
                    w + ((long long)c * 9 + u * K::TPS) * (K::TAP_BYTES / 2),
                    K::W_STAGE, w_full + 8 * ws);
        }
      }
    }
    return;
  }

  // The warpgroups: after each group of wgmmas is issued, the group
  // before it is waited on and its stages are released by predicated
  // arrivals (no branch between a wgmma and its wait).
  const int lane = t & 31;
  const int p0 = (t >> 5) * 16 + (lane >> 2), c0 = (lane & 3) * 2;
  const uint32_t row_off = wg * (TW + 2) * CK * 2;  // the row's halo pixels
  const float k02 = round_to<T>(0.2f);
  long long gh = 0, gw = 0;
  for (long long tile = blockIdx.x; tile < g.count; tile += gridDim.x) {
    int b, y0, x0;
    g.origin(tile, b, y0, x0);
    float acc[N / 2], cor[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = cor[i] = 0.f;
    for (int c = 0; c < chunks; ++c, ++gh) {
      const int hs = (int)(gh % K::HS);
      mbar_wait(halo_full + 8 * hs, (uint32_t)((gh / K::HS) & 1));
      const uint32_t a_row = base + hs * K::HALO_STAGE + row_off;
#pragma unroll
      for (int u = 0; u < K::UNITS; ++u, ++gw) {
        const int ws = (int)(gw % K::WS);
        mbar_wait(w_full + 8 * ws, (uint32_t)((gw / K::WS) & 1));
        const uint32_t wst = base + (uint32_t)(K::OFF_W + ws * K::W_STAGE);
        fence_regs(acc);
        if constexpr (F32) fence_regs(cor);
        wgmma_fence();
#pragma unroll
        for (int tl = 0; tl < K::TPS; ++tl) {
          const int tap = u * K::TPS + tl;
          const uint32_t a =
              a_row + ((tap / 3) * (TW + 2) + tap % 3) * CK * 2;
          const uint32_t wt = wst + tl * K::TAP_BYTES;
#pragma unroll
          for (int kc = 0; kc < CK / 16; ++kc)
            mma_step<F32, N>(acc, cor, a + kc * 32, wt + 2 * kc * N * 16);
        }
        wgmma_commit();
        fence_regs(acc);
        if constexpr (F32) fence_regs(cor);
        // the group before this one is done: release its weight stage,
        // and its chunk's halo when it was the chunk's last (u == 0)
        wgmma_wait<1>();
        mbar_arrive_if(w_empty + 8 * (int)((gw + K::WS - 1) % K::WS),
                       (c > 0 || u > 0) && t == 0);
        mbar_arrive_if(halo_empty + 8 * (int)((gh + K::HS - 1) % K::HS),
                       c > 0 && u == 0 && t == 0);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if constexpr (F32) fence_regs(cor);
    mbar_arrive_if(w_empty + 8 * (int)((gw - 1) % K::WS), t == 0);
    mbar_arrive_if(halo_empty + 8 * (int)((gh - 1) % K::HS), t == 0);

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
        for (int e = 0; e < 2; ++e) {
          const int q = 4 * j + 2 * h + e;
          // conv + b in float32, cast to the compute dtype
          if constexpr (F32)
            v[e] = __fadd_rn(__fadd_rn(acc[q], cor[q]), bs[c + e]);
          else
            v[e] = round_to<T>(__fadd_rn(acc[q], bs[c + e]));
        }
        if (epi == LRELU) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = v[e] >= 0.f ? v[e] : round_to<T>(__fmul_rn(v[e], k02));
        } else {
          const float2 x2 = load2<T>(res + pix * res_px + c);
          if (epi == ADD) {
            v[0] = round_to<T>(__fadd_rn(x2.x, v[0]));
            v[1] = round_to<T>(__fadd_rn(x2.y, v[1]));
          } else {
            v[0] = scaled_add<T>(v[0], k02, x2.x);
            v[1] = scaled_add<T>(v[1], k02, x2.y);
            if (epi == RRDB) {
              const float2 r2 = load2<T>(res2 + pix * res2_px + c);
              v[0] = scaled_add<T>(v[0], k02, r2.x);
              v[1] = scaled_add<T>(v[1], k02, r2.y);
            }
          }
        }
        store2<T>(out + pix * out_px + c, v[0], v[1]);
      }
  }
}

template <bool F32, int N>
cudaError_t launch(const void* x, int cs, const void* wp, const float* b,
                   const void* res, int res_px, const void* res2,
                   int res2_px, void* out, int out_px, int epi, int cin,
                   int B, int H, int W, cudaStream_t stream) {
  using K = K7<F32, N>;
  using T = typename K::T;
  if (cin <= 0 || cin % CK || cin > cs || epi < LRELU || epi > ADD)
    return cudaErrorInvalidValue;
  const long long tiles =
      (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  // bf16: the Cin channels of the Cs-channel buffer; float32: the three
  // planes (3, B, H, W, Cin) of their split
  CUtensorMap map;
  cudaError_t err =
      halo_map(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K::PLANES * B,
               H, W, TW + 2, TH + 2, CU_TENSOR_MAP_SWIZZLE_64B, CK, cin, cs);
  if (err != cudaSuccess) return err;
  auto kernel = dense_conv_kernel<F32, N>;
  int grid = 0;
  err = reve::persistent_grid(kernel, THREADS, K::SMEM, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, K::SMEM, stream>>>(
      map, static_cast<const bf16*>(wp), b, static_cast<const T*>(res),
      res_px, static_cast<const T*>(res2), res2_px, static_cast<T*>(out),
      out_px, epi, cin / CK, B, H, W);
  return cudaGetLastError();
}

template <bool F32>
cudaError_t dispatch(const void* x, int cs, const void* wp, const float* b,
                     const void* res, int res_px, const void* res2,
                     int res2_px, void* out, int out_px, int epi, int cin,
                     int cout, int B, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 32:
      return launch<F32, 32>(x, cs, wp, b, res, res_px, res2, res2_px, out,
                             out_px, epi, cin, B, H, W, s);
    case 64:
      return launch<F32, 64>(x, cs, wp, b, res, res_px, res2, res2_px, out,
                             out_px, epi, cin, B, H, W, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// K7 in bfloat16: `x` the (B, H, W, cs) buffer, of which the conv reads
// channels [0, cin); `wp` the weights packed as [cin / 32][tap][k / 8][n]
// [8]; `out` the first of the cout channels it writes, pixels out_px
// values apart; `res`, `res2` the residuals' first channels (pixels
// res_px, res2_px apart; unused by the forms that do not read them);
// `epi` 0 LRELU, 1 RDB, 2 RRDB, 3 ADD.  Returns a cudaError_t.
extern "C" int reve_dense_conv_tc(const void* x, const void* wp,
                                  const float* b, const void* res,
                                  const void* res2, void* out, int B, int H,
                                  int W, int cin, int cs, int cout,
                                  int res_px, int res2_px, int out_px,
                                  int epi, void* stream) {
  return (int)dispatch<false>(x, cs, wp, b, res, res_px, res2, res2_px, out,
                              out_px, epi, cin, cout, B, H, W, stream);
}

// K7 in float32, on the split planes (3, B, H, W, cin) bf16 of the
// channels it reads, the weights packed as [cin / 32][tap][split][k / 8]
// [n][8]; the rest as reve_dense_conv_tc.  Returns a cudaError_t.
extern "C" int reve_dense_conv_f32tc(const void* planes, const void* wp,
                                     const float* b, const void* res,
                                     const void* res2, void* out, int B,
                                     int H, int W, int cin, int cout,
                                     int res_px, int res2_px, int out_px,
                                     int epi, void* stream) {
  return (int)dispatch<true>(planes, cin, wp, b, res, res_px, res2, res2_px,
                             out, out_px, epi, cin, cout, B, H, W, stream);
}
