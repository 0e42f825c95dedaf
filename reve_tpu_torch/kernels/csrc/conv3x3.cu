// K3 conv3x3_u8_bias_prelu and K4a conv3x3_u8_bias_prelu_q8: the u8 input
// conv 3 -> 64 of the SRVGG, NHWC x HWIO -> NHWC, on the tensor cores.
//   x   = dtype(float32(u8) * float32(1/255))    SAME zero padding
//   h   = PReLU(dtype(conv(x, w) + b))           float32 accumulation and
//                                                + b; PReLU in the dtype
//   K3  y = h                                    bfloat16 or float32
//   K4a y = clip(round(float32(h) * inv), +-127)  s8, half to even,
//                                                inv = 1 / act_scale[0]
//
// Replaces (TPU side): the XLA-fused conv graph of
//   K3  the u8 -> float32 * (1/255) -> compute-dtype cast of the engine
//       (reve_tpu/pipeline/engine.py:645, srvgg.py:154) fused with the first
//       3->64 conv + PReLU (srvgg.py:203-204);
//   K4a the int8 path's first conv + PReLU + _quant_s8 (srvgg.py:376-379).
//
// Bound on an H100 SXM (3.35 TB/s) per call of 4 1080p frames (8,294,400
// pixels): 25 MB of u8 in and 64 channels out: K3 bfloat16 1.087 GB ->
// 0.324 ms, K3 float32 2.148 GB -> 0.641 ms, K4a 0.556 GB -> 0.166 ms, all
// bytes.  The conv is 28.7 GFLOP (K = 27): 0.43 ms of FMA issue at the
// CUDA cores' 67 TF/s, above two of those bounds, so only a tensor-core
// form can reach them.  On the tensor cores at K = 32 it is 34 GFLOP:
// 0.034 ms in bf16, 0.21 ms as float32's six bf16 passes.
//
// Design: an implicit GEMM of M = the 64 pixels of a row, N = 64 channels
// and K = 27 taps x channels laid out in 32, on m64n64k16 wgmma: two a row
// in bfloat16, twelve in float32 (six bf16 products of operands split in
// three, hi.hi in its own accumulators, as conv3x3_f32_tc.cu does: the
// tensor cores add in their own order and may truncate).  One template
// serves the four kernels (K3 and K4a, each in both compute dtypes).
//  * Blocks of one warpgroup, persistent, several on each SM (U8::BLOCKS,
//    measured), walk tiles of one row of 64 pixels.  Each block packs the
//    HWIO weights once into the B operand in shared memory ([split][k /
//    8][n][8] bf16: 4 KB, 12 KB in float32).
//  * The halo (3 rows x 66 pixels x 3 channels) comes as the 4-B words
//    that hold each row's 198 bytes, read by the threads two tiles ahead
//    into registers.  TMA cannot load it as rows (W * 3 bytes meets no
//    16-B stride rule), and boxes of a 1-D map over the frames' bytes
//    fault unless they start 16-B aligned and, so started, took as long
//    as these loads; either way the loads are issued right after a
//    tile's proxy fence, since that fence waits for every load in flight.
//  * The words go to a raw buffer, and the halo is staged from there
//    converted once per value through a 256-entry table (bf16 x, or
//    float32 x as its bf16 hi, mid, lo): value (row r, channel c) of halo
//    pixel px at slot 3r + c of the pixel's 10.  With taps numbered column
//    by column, k = 10 dx + 3 dy + c (k = 9, 19, 29..31 zero in B), the
//    value k of output pixel p is halo value 10 p + k: each register of
//    the A fragment is one aligned shared-memory read, and A never goes
//    through shared memory as a wgmma operand.
//  * The output, which sets the time, is staged in shared memory in the
//    swizzle of its tensor map (128 B for bf16 and, as two boxes of 32
//    channels, for float32; 64 B for s8) and written by TMA stores from
//    two staging buffers: a buffer is written again only after its store
//    two tiles before has read it (cp.async.bulk.wait_group.read), so each
//    store overlaps the next tile's halo, wgmmas and epilogue.  TMA clips
//    the ragged right edge.
//  * The epilogue rounds where the reference does (__fadd_rn, __fmul_rn;
//    no FMA contraction).  It avoids conversion instructions, which issue
//    at a quarter of the float32 rate on this card: bf16 PReLU is one
//    bf16x2 fma after one packing conversion a pair, and K4a's quantize
//    adds 1.5 * 2^23 in float32 (quant_bits).
#include <type_traits>

#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace reve::tc;

constexpr int CIN = 3;    // the u8 frames' channels
constexpr int COUT = 64;
constexpr int TW = 64;    // tile: one row of 64 pixels, the M of a wgmma
constexpr int THREADS = 128;  // one warpgroup
constexpr int KP = 32;    // K: 27 taps x channels, with zeros, to 32
constexpr int HALO_PX = TW + 2;           // halo pixels of a tile row
constexpr int SLOTS = 10;                 // halo values a pixel: 9 + 0
// halo values: 66 pixels x 10 slots, and what k = 29..31 read past the
// last pixel (zeros)
constexpr int HALO_VALS = HALO_PX * SLOTS + 12;
// 4-B words read of a halo row: its 198 bytes from up to 3 bytes into
// the first; a thread reads words t and t + 128 of the 3 rows' 153
constexpr int ROW_WORDS = 51;
constexpr int RAW_ROW = 256;   // bytes between rows in the raw buffer
// output staging buffers: a tile's store may read its buffer while the
// next NOUT - 1 tiles compute
constexpr int NOUT = 2;
constexpr int PAIRS = 3 * HALO_PX;        // (row, pixel) pairs: 198

// T: the compute dtype (bf16 or float); TOut: T for K3, int8_t for K4a.
template <typename T, typename TOut>
struct U8 {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr bool Q8 = std::is_same<TOut, int8_t>::value;
  static constexpr int SPLITS = F32 ? 3 : 1;          // hi (, mid, lo)
  static constexpr int W_BYTES = SPLITS * KP * COUT * 2;
  static constexpr int V = F32 ? 8 : 2;  // a staged value: bf16 (x 3)
  // one staged output row: 8 KB bf16, 16 KB float32, 4 KB s8
  static constexpr int OUT_BYTES = TW * COUT * (int)sizeof(TOut);
  static constexpr size_t OFF_W = NOUT * OUT_BYTES;  // after the buffers
  static constexpr size_t OFF_RAW = OFF_W + W_BYTES;   // the raw words
  static constexpr size_t OFF_HALO = OFF_RAW + 3 * RAW_ROW;
  // the table of a u8 value's staged form: bf16, or bf16 hi | mid, lo
  static constexpr size_t OFF_TABLE = OFF_HALO + HALO_VALS * V;
  static constexpr size_t OFF_ZEROS = OFF_TABLE + 256 * V;  // 16 B
  static constexpr size_t SMEM = OFF_ZEROS + 16;
  // the output's tensor map: channels a box holds, its swizzle
  static constexpr int BOX_C = F32 && !Q8 ? 32 : 64;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      Q8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr CUtensorMapDataType MAP_TYPE =
      Q8    ? CU_TENSOR_MAP_DATA_TYPE_UINT8
      : F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // blocks on each SM: the registers must allow them, and no more run
  // (the fastest counts on an H100 SXM; perf_conv_tc_parts times one
  // fewer and one more)
  static constexpr int BLOCKS = F32 ? (Q8 ? 3 : 2) : (Q8 ? 6 : 4);
};

// The persistent walk over tiles of one row of 64 pixels, x fastest:
// image b, row y, tile column xt, advanced by `step` tiles with no
// division (gx = step % tx, gy = step / tx, taken once).
struct Walk {
  int b, y, xt;
  __device__ Walk(int tile, int H, int tx)
      : b(tile / (H * tx)), y(tile / tx % H), xt(tile % tx) {}
  __device__ void advance(int gx, int gy, int tx, int H) {
    xt += gx;
    y += gy;
    if (xt >= tx) {
      xt -= tx;
      ++y;
    }
    while (y >= H) {
      y -= H;
      ++b;
    }
  }
};

// The u8 halo words of the tile at (b, y0, x0), this thread's share:
// word j = t + 128 n (n < 2) of 3 rows x 51 words, those that hold bytes
// s_r .. s_r + 197 of the frames (s_r: pixel x0 - 1 of row y0 - 1 + r,
// whose first word starts at s_r & ~3), 0 for a row outside the frame or
// bytes outside the frames' `bytes`.  Plain loads into registers: a
// thread's proxy fence waits for them, so they are issued right after it.
__device__ __forceinline__ void fetch(const uint8_t* __restrict__ x,
                                      int bytes, int b, int y0, int x0,
                                      int H, int W, int t,
                                      uint32_t (&v)[2]) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int j = t + 128 * n, r = j / ROW_WORDS;
    const int wb = ((((b * H + y0 - 1 + r) * W + x0 - 1) * CIN) & ~3) +
                   4 * (j - r * ROW_WORDS);
    uint32_t w = 0;
    if (j < 3 * ROW_WORDS && (unsigned)(y0 - 1 + r) < (unsigned)H) {
      if (wb >= 0 && wb + 4 <= bytes) {
        w = __ldg(reinterpret_cast<const uint32_t*>(x + wb));
      } else {  // the frames' first or last word, in part
        for (int k = 0; k < 4; ++k)
          if (wb + k >= 0 && wb + k < bytes) w |= (uint32_t)x[wb + k] << 8 * k;
      }
    }
    v[n] = w;
  }
}

// ... and their place in the raw buffer: row r at r * RAW_ROW.
__device__ __forceinline__ void put_words(unsigned char* raw, int t,
                                          const uint32_t (&v)[2]) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int j = t + 128 * n, r = j / ROW_WORDS;
    if (j < 3 * ROW_WORDS)
      reinterpret_cast<uint32_t*>(raw + r * RAW_ROW)[j - r * ROW_WORDS] =
          v[n];
  }
}

// The staged form of u8 value u: x = float32(u) * float32(1/255) as bf16
// (2 B), or float32 x as its bf16 hi, mid, lo (8 B: hi | mid << 16, lo;
// hi + mid + lo == x, each subtraction exact in float32).  A block builds
// the 256 entries once; staging a halo value is then one table read.
template <bool F32>
__device__ __forceinline__ void unit_entry(unsigned char* table, int u) {
  const float xv = reve::u8_to_unit((uint8_t)u);
  const bf16 hi = __float2bfloat16_rn(xv);
  if constexpr (F32) {
    const float r = __fsub_rn(xv, __bfloat162float(hi));
    const bf16 mid = __float2bfloat16_rn(r);
    const bf16 lo = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid)));
    reinterpret_cast<uint2*>(table)[u] =
        make_uint2(__bfloat16_as_ushort(hi) |
                       (uint32_t)__bfloat16_as_ushort(mid) << 16,
                   __bfloat16_as_ushort(lo));
  } else {
    reinterpret_cast<bf16*>(table)[u] = hi;
  }
}

// Stage the raw halo as the A operand's source, through the table: value
// (row r, channel c) of halo pixel px at slot 3r + c of the pixel's 10
// (slot 9 stays zero), 2 B (bf16) or 8 B (float32's three splits) a
// value.  Each thread converts the 3 values of (row, pixel) pairs t and
// t + 128; rows and pixels outside the frame read `zeros`.  A row's
// pixel x0 - 1 starts s_r % 4 bytes into its first word.
template <bool F32>
__device__ __forceinline__ void stage(unsigned char* halo,
                                      const unsigned char* raw,
                                      const unsigned char* zeros,
                                      const unsigned char* table, int t,
                                      int b, int y0, int x0, int H, int W) {
  using E = typename std::conditional<F32, uint2, unsigned short>::type;
  const int s0 = ((b * H + y0 - 1) * W + x0 - 1) * CIN;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int m = t + THREADS * n;
    if (m >= PAIRS) break;
    const int r = m / HALO_PX, px = m - r * HALO_PX;
    const int s = s0 + r * W * CIN;
    const bool in = (unsigned)(y0 - 1 + r) < (unsigned)H &&
                    (unsigned)(x0 - 1 + px) < (unsigned)W;
    const unsigned char* src =
        in ? raw + r * RAW_ROW + (s & 3) + px * CIN : zeros;
    E* dst = reinterpret_cast<E*>(halo) + px * SLOTS + 3 * r;
#pragma unroll
    for (int c = 0; c < CIN; ++c)
      dst[c] = reinterpret_cast<const E*>(table)[src[c]];
  }
}

// The row's GEMM, this thread's part: the A fragments of both k16 steps
// from the staged halo, then the wgmmas, waited on.  With taps numbered
// column by column, k = 10 dx + 3 dy + c, the value k of output pixel p is
// halo value 10 p + k: register r of step kc holds pixel pa + 8 (r % 2),
// k = 2q + 16 kc + 8 (r / 2) + {0, 1}, one aligned read (bf16: 4 B;
// float32: 16 B, both values' hi | mid, lo).  float32: hi.hi into `acc`,
// the five smaller products into `cor`, smallest first.
template <bool F32>
__device__ __forceinline__ void mma_row(float (&acc)[32], float (&cor)[32],
                                        const unsigned char* a_src,
                                        uint32_t w) {
  constexpr int WPLANE = KP * COUT * 2;
  constexpr int V = F32 ? 8 : 2;  // bytes of a staged value
  uint32_t a[F32 ? 3 : 1][2][4];
#pragma unroll
  for (int kc = 0; kc < 2; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const unsigned char* p =
          a_src + ((r & 1) * 8 * SLOTS + kc * 16 + (r >> 1) * 8) * V;
      if constexpr (F32) {
        const uint4 e = *reinterpret_cast<const uint4*>(p);
        a[0][kc][r] = __byte_perm(e.x, e.z, 0x5410);  // hi
        a[1][kc][r] = __byte_perm(e.x, e.z, 0x7632);  // mid
        a[2][kc][r] = __byte_perm(e.y, e.w, 0x5410);  // lo
      } else {
        a[0][kc][r] = *reinterpret_cast<const uint32_t*>(p);
      }
    }
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  // every write of A and of the accumulators comes before the fence
#pragma unroll
  for (int sp = 0; sp < (F32 ? 3 : 1); ++sp)
#pragma unroll
    for (int kc = 0; kc < 2; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[sp][kc][r]));
  fence_regs(acc);
  if constexpr (F32) {
#pragma unroll
    for (int i = 0; i < 32; ++i) cor[i] = 0.f;
    fence_regs(cor);
  }
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 2; ++kc) {
    // B of step kc: k blocks 2kc, 2kc + 1, 1024 B apart
    const uint32_t wb = w + kc * 2048;
    if constexpr (F32) {
      const uint64_t bh = desc(wb, 1024), bm = desc(wb + WPLANE, 1024),
                     bl = desc(wb + 2 * WPLANE, 1024);
      Wgmma<64>::mma(cor, a[2][kc], bh);
      Wgmma<64>::mma(cor, a[0][kc], bl);
      Wgmma<64>::mma(cor, a[1][kc], bm);
      Wgmma<64>::mma(cor, a[1][kc], bh);
      Wgmma<64>::mma(cor, a[0][kc], bm);
      Wgmma<64>::mma(acc, a[0][kc], bh);
    } else {
      Wgmma<64>::mma(acc, a[0][kc], desc(wb, 1024));
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);  // keep every read of the accumulators below the wait
  if constexpr (F32) fence_regs(cor);
}

// The s8 code of x * inv, rounded half to even and clipped to +-127
// (reve_tpu srvgg._quant_s8), as the low byte of the result.  Clip first
// (+-127 are integers: clip(rint(v)) == rint(clip(v))), then add 1.5 *
// 2^23, where the float32 spacing is 1: the sum rounds to the nearest
// integer, ties to even, and its low byte is the code in two's
// complement.  Float32 arithmetic only: a conversion instruction issues at
// a quarter of that rate on this card, and K4a would have one a value.
__device__ __forceinline__ uint32_t quant_bits(float x, float inv) {
  const float v = fminf(fmaxf(__fmul_rn(x, inv), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(v, 12582912.f));
}

// The epilogue of this thread's accumulators into the staging buffer `st`,
// in the swizzle of the output's tensor map.  Register 4j + 2h + e holds
// pixel pa + 8h, channel 8j + 2q + e; bi, al (float32) and al2 (bf16
// pairs) are those channels' bias and alpha.
template <typename T, typename TOut>
__device__ __forceinline__ void epilogue(unsigned char* st,
                                         const float (&acc)[32],
                                         const float (&cor)[32],
                                         const float (&bi)[16],
                                         const float (&al)[16],
                                         const __nv_bfloat162 (&al2)[8],
                                         float inv, int pa, int q) {
  using U = U8<T, TOut>;
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = pa + 8 * h, r = 4 * j + 2 * h;
      float v[2];
      uint32_t hb = 0;
      if constexpr (U::F32) {
        // conv + b in float32; PReLU in float32
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float f =
              __fadd_rn(__fadd_rn(acc[r + e], cor[r + e]), bi[2 * j + e]);
          v[e] = f > 0.f ? f : __fmul_rn(al[2 * j + e], f);
        }
      } else {
        // conv + b in float32, cast to bf16; PReLU in bf16, max(f, 0) +
        // bf16(alpha * min(f, 0)), as one bf16x2 fma: alpha * 0 + f is f,
        // and alpha * f + 0 rounds once
        const __nv_bfloat162 f =
            __floats2bfloat162_rn(__fadd_rn(acc[r], bi[2 * j]),
                                  __fadd_rn(acc[r + 1], bi[2 * j + 1]));
        const __nv_bfloat162 pr =
            __hfma2(al2[j], __hmin2(f, zero), __hmax2(f, zero));
        hb = *reinterpret_cast<const uint32_t*>(&pr);
        v[0] = __uint_as_float(hb << 16);
        v[1] = __uint_as_float(hb & 0xFFFF0000u);
      }
      if constexpr (U::Q8) {
        // 64-B rows; 16-B chunk c of pixel p at chunk c ^ ((p / 2) % 4)
        *reinterpret_cast<uint16_t*>(
            st + p * 64 + (((j >> 1) ^ ((p >> 1) & 3)) << 4) + 8 * (j & 1) +
            2 * q) = (uint16_t)__byte_perm(quant_bits(v[0], inv),
                                           quant_bits(v[1], inv), 0x40);
      } else if constexpr (U::F32) {
        // two boxes of 32 channels, each 128-B rows; chunk c of pixel p at
        // chunk c ^ (p % 8)
        *reinterpret_cast<float2*>(
            st + (j >> 2) * (TW * 128) + p * 128 +
            (((2 * (j & 3) + (q >> 1)) ^ (p & 7)) << 4) + (q & 1) * 8) =
            make_float2(v[0], v[1]);
      } else {
        *reinterpret_cast<uint32_t*>(st + p * 128 + ((j ^ (p & 7)) << 4) +
                                     4 * q) = hb;
      }
    }
}

// The block's B operand, packed from the HWIO weights (3, 3, 3, 64) in
// the compute dtype: [split][k / 8][n][8] bf16 (core matrices of 8 rows x
// 16 B, K-major), tap (dy, dx), channel c at k = 10 dx + 3 dy + c and
// zeros at k = 9, 19, 29..31 (kernels/conv3x3.py pack_weights_u8conv is
// its reference); float32 as its bf16 hi, mid, lo, one split a plane.
// Packed here, once a block, not by the wrapper: the small torch ops of a
// packing took longer than a tenth of the kernel.
template <typename T>
__device__ __forceinline__ void pack_weights(bf16* ws,
                                             const T* __restrict__ w,
                                             int t) {
  for (int i = t; i < KP * COUT; i += THREADS) {
    const int k = i / COUT, n = i - k * COUT;
    const int dx = k / 10, s = k - 10 * dx;  // s = 3 dy + c
    const float v =
        dx < 3 && s < 9 ? reve::to_float(w[((s / 3 * 3 + dx) * CIN + s % 3) *
                                           COUT + n])
                        : 0.f;
    const int at = ((k >> 3) * COUT + n) * 8 + (k & 7);
    const bf16 hi = __float2bfloat16_rn(v);
    ws[at] = hi;
    if constexpr (std::is_same<T, float>::value) {
      const float r = __fsub_rn(v, __bfloat162float(hi));
      const bf16 mid = __float2bfloat16_rn(r);
      ws[KP * COUT + at] = mid;
      ws[2 * KP * COUT + at] =
          __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid)));
    }
  }
}

template <typename T, typename TOut>
__global__ void __launch_bounds__(THREADS, U8<T, TOut>::BLOCKS)
conv3x3_u8_tc_kernel(const __grid_constant__ CUtensorMap out_map,
                     const uint8_t* __restrict__ x,
                     const T* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ alpha,
                     const float* __restrict__ inv, int B, int H, int W) {
  using U = U8<T, TOut>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  unsigned char* halo = smem + U::OFF_HALO;
  unsigned char* table = smem + U::OFF_TABLE;
  const int t = threadIdx.x;
  const int lane = t & 31, q = lane & 3;
  const int pa = (t >> 5) * 16 + (lane >> 2);  // this thread's pixel rows
  for (int u = t; u < 256; u += THREADS) unit_entry<U::F32>(table, u);
  // the halo's pad slots stay zero, and so do the zeros
  for (int i = t; i < HALO_VALS * U::V / 4; i += THREADS)
    reinterpret_cast<uint32_t*>(halo)[i] = 0;
  if (t < 4) reinterpret_cast<uint32_t*>(smem + U::OFF_ZEROS)[t] = 0;
  pack_weights(reinterpret_cast<bf16*>(smem + U::OFF_W), w, t);
  fence_proxy_async();
  __syncthreads();

  // the grid never exceeds the tile count; each block walks its tiles
  // `step` apart and reads the halo words of the tile after next
  const int tx = (W + TW - 1) / TW, count = B * H * tx, step = gridDim.x;
  const int gx = step % tx, gy = step / tx, bytes = B * H * W * CIN;
  unsigned char* raw = smem + U::OFF_RAW;
  Walk cur(blockIdx.x, H, tx), ahead = cur;
  uint32_t words[2];
  fetch(x, bytes, ahead.b, ahead.y, ahead.xt * TW, H, W, t, words);
  put_words(raw, t, words);
  ahead.advance(gx, gy, tx, H);
  if (blockIdx.x + step < count)
    fetch(x, bytes, ahead.b, ahead.y, ahead.xt * TW, H, W, t, words);
  ahead.advance(gx, gy, tx, H);
  __syncthreads();
  // this thread's channels 8j + 2q + e: bias, and alpha as the dtype
  // rounds it (the wrapper rounds it, so the bf16 pairs are exact)
  float bi[16], al[16];
  __nv_bfloat162 al2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bi[2 * j + e] = bias[8 * j + 2 * q + e];
      al[2 * j + e] = alpha[8 * j + 2 * q + e];
    }
    al2[j] = __floats2bfloat162_rn(al[2 * j], al[2 * j + 1]);
  }
  const float inv_s = U::Q8 ? *inv : 0.f;
  const unsigned char* a_src = halo + (pa * SLOTS + 2 * q) * U::V;
  for (int tile = blockIdx.x, it = 0; tile < count; tile += step, ++it) {
    const int buf = it % NOUT;
    // every thread read the last staged halo before the barrier after
    // its wgmmas, and these raw words were put before the last barrier
    stage<U::F32>(halo, raw, smem + U::OFF_ZEROS, table, t, cur.b, cur.y,
                  cur.xt * TW, H, W);
    // this tile's staging buffer was read out by the store NOUT tiles ago
    if (t == 0) bulk_wait_read<NOUT - 1>();
    __syncthreads();
    float acc[32], cor[32];
    mma_row<U::F32>(acc, cor, a_src, base + (uint32_t)U::OFF_W);
    unsigned char* st = smem + buf * U::OUT_BYTES;
    epilogue<T, TOut>(st, acc, cor, bi, al, al2, inv_s, pa, q);
    // the next tile's halo words, read a tile ago (every thread is done
    // with the raw buffer: it staged this tile's before the barrier)
    put_words(raw, t, words);
    fence_proxy_async();  // the staged row becomes visible to TMA
    __syncthreads();
    if (t == 0) {
      const uint32_t src = base + buf * U::OUT_BYTES;
      tma_store_4d(&out_map, src, 0, cur.xt * TW, cur.y, cur.b);
      if constexpr (U::BOX_C == 32)
        tma_store_4d(&out_map, src + TW * 128, 32, cur.xt * TW, cur.y,
                     cur.b);
      bulk_commit();
    }
    // the words of the tile after next: the fence above waits for every
    // load in flight, so they are read after it
    if (tile + 2 * step < count)
      fetch(x, bytes, ahead.b, ahead.y, ahead.xt * TW, H, W, t, words);
    cur.advance(gx, gy, tx, H);
    ahead.advance(gx, gy, tx, H);
  }
  if (t == 0) bulk_wait<0>();  // the stores have read their buffers
}

template <typename T, typename TOut>
cudaError_t launch(const void* x, const void* w, const float* b,
                   const float* a, const float* inv, void* y, int B, int H,
                   int W, cudaStream_t stream) {
  using U = U8<T, TOut>;
  const long long tiles = (long long)B * H * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  // the kernel walks tiles and addresses input bytes in int
  if ((long long)B * H * W * CIN >= (1LL << 31)) return cudaErrorInvalidValue;
  CUtensorMap out_map;
  cudaError_t err = halo_map(&out_map, U::MAP_TYPE, (int)sizeof(TOut), y, B,
                             H, W, TW, 1, U::SWIZZLE, U::BOX_C);
  if (err != cudaSuccess) return err;
  auto kernel = conv3x3_u8_tc_kernel<T, TOut>;
  int grid = 0;
  err = reve::persistent_grid(kernel, THREADS, U::SMEM, tiles, &grid,
                              U::BLOCKS);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, U::SMEM, stream>>>(
      out_map, static_cast<const uint8_t*>(x), static_cast<const T*>(w), b, a,
      inv, B, H, W);
  return cudaGetLastError();
}

}  // namespace

// K3.  `w`: the HWIO weights (3, 3, 3, 64) in the compute dtype; `alpha`
// rounded to the compute dtype; dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t (0 = success).
extern "C" int reve_conv3x3_u8_bias_prelu(const void* x, const void* w,
                                          const float* b, const float* alpha,
                                          void* y, int B, int H, int W,
                                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch<bf16, bf16>(x, w, b, alpha, nullptr, y, B, H, W, s);
  if (dtype == 0)
    return (int)launch<float, float>(x, w, b, alpha, nullptr, y, B, H, W,
                                     s);
  return (int)cudaErrorInvalidValue;
}

// K4a: K3 with the s8 quantize epilogue; `inv` is a device pointer to
// float32(1 / act_scale[0]).
extern "C" int reve_conv3x3_u8_bias_prelu_q8(const void* x, const void* w,
                                             const float* b,
                                             const float* alpha,
                                             const float* inv, void* y, int B,
                                             int H, int W, int dtype,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch<bf16, int8_t>(x, w, b, alpha, inv, y, B, H, W, s);
  if (dtype == 0)
    return (int)launch<float, int8_t>(x, w, b, alpha, inv, y, B, H, W, s);
  return (int)cudaErrorInvalidValue;
}
