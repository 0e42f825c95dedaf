// K3 conv3x3_u8_bias_prelu and K4a conv3x3_u8_bias_prelu_q8: the u8 input
// conv 3 -> 64 of the SRVGG, NHWC x HWIO -> NHWC, on the tensor cores;
// and K3 at Cin 12, conv3x3_u8x2_bias: RRDB x2's conv_first 12 -> 64 over
// the 2x2-unshuffled u8 frame (its PReLU at alpha 1, the identity).
//   x   = dtype(float32(u8) * float32(1/255))    SAME zero padding
//         (at Cin 12: unshuffled, channel 4c + 2i + j of pixel (y, x)
//         is u8[2y + i, 2x + j, c], reve_tpu pixel_unshuffle's order)
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
//   K4a the int8 path's first conv + PReLU + _quant_s8 (srvgg.py:376-379);
//   K3 at Cin 12: reve_tpu/ops/pixel_shuffle.py::pixel_unshuffle (:52-64)
//       then RRDB's conv_first (reve_tpu/models/rrdb.py:192-193, :212;
//       apply_int8 :288-291, :306), in bfloat16 or float32.
//
// Bound on an H100 SXM (3.35 TB/s) per call of 4 1080p frames (8,294,400
// pixels): 25 MB of u8 in and 64 channels out: K3 bfloat16 1.087 GB ->
// 0.324 ms, K3 float32 2.148 GB -> 0.641 ms, K4a 0.556 GB -> 0.166 ms, all
// bytes.  The conv is 28.7 GFLOP (K = 27): 0.43 ms of FMA issue at the
// CUDA cores' 67 TF/s, above two of those bounds, so only a tensor-core
// form can reach them.  On the tensor cores at K = 32 it is 34 GFLOP:
// 0.034 ms in bf16, 0.21 ms as float32's six bf16 passes.  K3 at Cin 12,
// per call of 4 1080p frames at x2 (a trunk of 4 x 540 x 960): 24.9 MB of
// u8 in, 265 MB bf16 (531 MB float32) out -> 0.087 ms (0.166 ms): bytes
// in bfloat16; float32 as six bf16 passes at K = 112, about 178 GFLOP ->
// 0.18 ms: operations.
//
// Design: an implicit GEMM of M = the 64 pixels of a row, N = 64 channels
// and K = 27 taps x channels laid out in 32, on m64n64k16 wgmma: two a row
// in bfloat16, twelve in float32 (six bf16 products of operands split in
// three, hi.hi in its own accumulators, as conv3x3_f32_tc.cu does: the
// tensor cores add in their own order and may truncate).  One template
// serves the four kernels (K3 and K4a, each in both compute dtypes).
//  * The template's R is the unshuffle factor (Geo<R>): 1 for K3 and K4a
//    (Cin 3), 2 for K3 at Cin 12, whose halo is read in place from the
//    x2 frame (6 u8 rows of 132 pixels for a tile's 3 unshuffled rows of
//    66); no unshuffled copy is written.  The numbers below are R = 1's;
//    Geo<2> has them at Cin 12 (36 values a pixel, K = 108 in 112).
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

constexpr int COUT = 64;
constexpr int TW = 64;    // tile: one row of 64 pixels, the M of a wgmma
constexpr int THREADS = 128;  // one warpgroup
constexpr int HALO_PX = TW + 2;           // halo pixels of a tile row
// output staging buffers: a tile's store may read its buffer while the
// next NOUT - 1 tiles compute
constexpr int NOUT = 2;

// The halo's geometry at unshuffle factor R: the u8 frame is (R H, R W,
// 3), a conv input pixel (y, x) its R x R block, CIN = 3 R^2 channels.
template <int R>
struct Geo {
  static constexpr int CIN = 3 * R * R;    // 3, 12
  // halo values a pixel: its 3 rows x CIN channels (R = 1: 9 + 0)
  static constexpr int SLOTS = R == 1 ? 10 : 3 * CIN;   // 10, 36
  // K: 3 SLOTS, padded to whole k16 steps: 27 in 32, 108 in 112
  static constexpr int KP = R == 1 ? 32 : 112;
  static constexpr int KSTEPS = KP / 16;
  // halo values: 66 pixels x SLOTS, and what the last pixel's highest k
  // read past them (zeros)
  static constexpr int HALO_VALS = HALO_PX * SLOTS + (R == 1 ? 12 : 8);
  static constexpr int ROWS = 3 * R;       // u8 rows of a tile's halo
  static constexpr int ROW_PX = HALO_PX * R;   // u8 pixels of such a row
  // 4-B words read of a halo row: its 198 R bytes from up to 3 bytes
  // into the first (51, 100); a thread reads words t + 128 n
  static constexpr int ROW_WORDS = (ROW_PX * 3 + 6) / 4;
  static constexpr int WORDS = ROWS * ROW_WORDS;      // 153, 600
  static constexpr int NW = (WORDS + THREADS - 1) / THREADS;   // 2, 5
  static constexpr int RAW_ROW = R == 1 ? 256 : 400;  // raw buffer rows
  static constexpr int PAIRS = ROWS * ROW_PX;  // (row, pixel): 198, 792
  static constexpr int NP = (PAIRS + THREADS - 1) / THREADS;   // 2, 7
  static_assert(ROW_WORDS * 4 <= RAW_ROW, "a raw row holds its words");
  static_assert(3 * SLOTS <= KP && (TW - 1) * SLOTS + KP <= HALO_VALS,
                "A's reads stay in the halo");
};

// T: the compute dtype (bf16 or float); TOut: T for K3, int8_t for K4a;
// R: the unshuffle factor (Geo).
template <typename T, typename TOut, int R = 1>
struct U8 {
  using G = Geo<R>;
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr bool Q8 = std::is_same<TOut, int8_t>::value;
  static constexpr int SPLITS = F32 ? 3 : 1;          // hi (, mid, lo)
  static constexpr int W_BYTES = SPLITS * G::KP * COUT * 2;
  static constexpr int V = F32 ? 8 : 2;  // a staged value: bf16 (x 3)
  // one staged output row: 8 KB bf16, 16 KB float32, 4 KB s8
  static constexpr int OUT_BYTES = TW * COUT * (int)sizeof(TOut);
  static constexpr size_t OFF_W = NOUT * OUT_BYTES;  // after the buffers
  static constexpr size_t OFF_RAW = OFF_W + W_BYTES;   // the raw words
  static constexpr size_t OFF_HALO = OFF_RAW + G::ROWS * G::RAW_ROW;
  // the table of a u8 value's staged form: bf16, or bf16 hi | mid, lo
  static constexpr size_t OFF_TABLE = OFF_HALO + G::HALO_VALS * V;
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
  // (R = 1: the fastest counts on an H100 SXM; perf_conv_tc_parts times
  // one fewer and one more; R = 2: what its A fragments' registers allow,
  // 84 of them in float32)
  static constexpr int BLOCKS =
      R == 1 ? (F32 ? (Q8 ? 3 : 2) : (Q8 ? 6 : 4)) : (F32 ? 2 : 3);
  static_assert(OFF_HALO % 16 == 0 && OFF_TABLE % 16 == 0,
                "16-B aligned halo reads");
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

// The u8 halo words of the tile at (b, y0, x0) of the (B, H, W) output,
// this thread's share: word j = t + 128 n (n < NW) of ROWS rows x
// ROW_WORDS words, those that hold bytes s_r .. s_r + 198 R - 1 of the
// (B, R H, R W, 3) frames (s_r: u8 pixel R (x0 - 1) of u8 row R (y0 - 1)
// + r, whose first word starts at s_r & ~3), 0 for a row outside the
// frame or bytes outside the frames' `bytes`.  Plain loads into
// registers: a thread's proxy fence waits for them, so they are issued
// right after it.
template <int R>
__device__ __forceinline__ void fetch(const uint8_t* __restrict__ x,
                                      int bytes, int b, int y0, int x0,
                                      int H, int W, int t,
                                      uint32_t (&v)[Geo<R>::NW]) {
  using G = Geo<R>;
  const int HU = R * H, WU = R * W;
#pragma unroll
  for (int n = 0; n < G::NW; ++n) {
    const int j = t + 128 * n, r = j / G::ROW_WORDS;
    const int row = R * (y0 - 1) + r;
    const int wb = ((((b * HU + row) * WU + R * (x0 - 1)) * 3) & ~3) +
                   4 * (j - r * G::ROW_WORDS);
    uint32_t w = 0;
    if (j < G::WORDS && (unsigned)row < (unsigned)HU) {
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
template <int R>
__device__ __forceinline__ void put_words(unsigned char* raw, int t,
                                          const uint32_t (&v)[Geo<R>::NW]) {
  using G = Geo<R>;
#pragma unroll
  for (int n = 0; n < G::NW; ++n) {
    const int j = t + 128 * n, r = j / G::ROW_WORDS;
    if (j < G::WORDS)
      reinterpret_cast<uint32_t*>(raw + r * G::RAW_ROW)[j - r * G::ROW_WORDS] =
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

// Stage the raw halo as the A operand's source, through the table, 2 B
// (bf16) or 8 B (float32's three splits) a value: the 3 values of u8 row
// r, u8 pixel u of the halo go to conv input pixel u / R, at slot
// CIN (r / R) + R (r % R) + u % R + R^2 c of its SLOTS: with dy = r / R
// and the unshuffled channel R^2 c + R (r % R) + u % R, slot CIN dy + ch
// (R = 1: 3 r + c of 10, slot 9 zero).  Each thread converts the pairs
// (r, u) t + 128 n; rows and pixels outside the frame read `zeros`.  A
// row's first pixel starts s_r % 4 bytes into its first word.
template <bool F32, int R>
__device__ __forceinline__ void stage(unsigned char* halo,
                                      const unsigned char* raw,
                                      const unsigned char* zeros,
                                      const unsigned char* table, int t,
                                      int b, int y0, int x0, int H, int W) {
  using E = typename std::conditional<F32, uint2, unsigned short>::type;
  using G = Geo<R>;
  const int HU = R * H, WU = R * W;
  const int s0 = ((b * HU + R * (y0 - 1)) * WU + R * (x0 - 1)) * 3;
#pragma unroll
  for (int n = 0; n < G::NP; ++n) {
    const int m = t + THREADS * n;
    if (m >= G::PAIRS) break;
    const int r = m / G::ROW_PX, u = m - r * G::ROW_PX;
    const int s = s0 + r * WU * 3;
    const bool in = (unsigned)(R * (y0 - 1) + r) < (unsigned)HU &&
                    (unsigned)(R * (x0 - 1) + u) < (unsigned)WU;
    const unsigned char* src =
        in ? raw + r * G::RAW_ROW + (s & 3) + u * 3 : zeros;
    E* dst = reinterpret_cast<E*>(halo) + (u / R) * G::SLOTS +
             G::CIN * (r / R) + R * (r % R) + u % R;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      dst[R * R * c] = reinterpret_cast<const E*>(table)[src[c]];
  }
}

// The row's GEMM, this thread's part: the A fragments of all KSTEPS k16
// steps from the staged halo, then the wgmmas, waited on.  With taps
// numbered column by column, k = SLOTS dx + CIN dy + c (R = 1: 10 dx +
// 3 dy + c), the value k of output pixel p is halo value SLOTS p + k:
// register r of step kc holds pixel pa + 8 (r % 2), k = 2q + 16 kc + 8 (r
// / 2) + {0, 1}, one aligned read (bf16: 4 B; float32: 16 B, both values'
// hi | mid, lo).  float32: hi.hi into `acc`, the five smaller products
// into `cor`, smallest first.
template <bool F32, int R>
__device__ __forceinline__ void mma_row(float (&acc)[32], float (&cor)[32],
                                        const unsigned char* a_src,
                                        uint32_t w) {
  using G = Geo<R>;
  constexpr int KS = G::KSTEPS;
  constexpr int WPLANE = G::KP * COUT * 2;
  constexpr int V = F32 ? 8 : 2;  // bytes of a staged value
  uint32_t a[F32 ? 3 : 1][KS][4];
#pragma unroll
  for (int kc = 0; kc < KS; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const unsigned char* p =
          a_src + ((r & 1) * 8 * G::SLOTS + kc * 16 + (r >> 1) * 8) * V;
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
    for (int kc = 0; kc < KS; ++kc)
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
  for (int kc = 0; kc < KS; ++kc) {
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

// The block's B operand, packed from the HWIO weights (3, 3, CIN, 64) in
// the compute dtype: [split][k / 8][n][8] bf16 (core matrices of 8 rows x
// 16 B, K-major), tap (dy, dx), channel c at k = SLOTS dx + CIN dy + c and
// zeros at the other k (R = 1: 9, 19, 29..31; R = 2: 108..111;
// kernels/conv3x3.py pack_weights_u8conv is its reference); float32 as
// its bf16 hi, mid, lo, one split a plane.  Packed here, once a block,
// not by the wrapper: the small torch ops of a packing took longer than
// a tenth of the kernel.
template <typename T, int R>
__device__ __forceinline__ void pack_weights(bf16* ws,
                                             const T* __restrict__ w,
                                             int t) {
  using G = Geo<R>;
  constexpr int KP = G::KP, CIN = G::CIN;
  for (int i = t; i < KP * COUT; i += THREADS) {
    const int k = i / COUT, n = i - k * COUT;
    const int dx = k / G::SLOTS, s = k - G::SLOTS * dx;  // s = CIN dy + c
    const float v =
        dx < 3 && s < 3 * CIN
            ? reve::to_float(
                  w[((s / CIN * 3 + dx) * CIN + s % CIN) * COUT + n])
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

// B, H, W: the output's; x is (B, R H, R W, 3).
template <typename T, typename TOut, int R>
__global__ void __launch_bounds__(THREADS, U8<T, TOut, R>::BLOCKS)
conv3x3_u8_tc_kernel(const __grid_constant__ CUtensorMap out_map,
                     const uint8_t* __restrict__ x,
                     const T* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ alpha,
                     const float* __restrict__ inv, int B, int H, int W) {
  using U = U8<T, TOut, R>;
  using G = Geo<R>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  unsigned char* halo = smem + U::OFF_HALO;
  unsigned char* table = smem + U::OFF_TABLE;
  const int t = threadIdx.x;
  const int lane = t & 31, q = lane & 3;
  const int pa = (t >> 5) * 16 + (lane >> 2);  // this thread's pixel rows
  for (int u = t; u < 256; u += THREADS) unit_entry<U::F32>(table, u);
  // the halo's pad slots stay zero, and so do the zeros
  for (int i = t; i < G::HALO_VALS * U::V / 4; i += THREADS)
    reinterpret_cast<uint32_t*>(halo)[i] = 0;
  if (t < 4) reinterpret_cast<uint32_t*>(smem + U::OFF_ZEROS)[t] = 0;
  pack_weights<T, R>(reinterpret_cast<bf16*>(smem + U::OFF_W), w, t);
  fence_proxy_async();
  __syncthreads();

  // the grid never exceeds the tile count; each block walks its tiles
  // `step` apart and reads the halo words of the tile after next
  const int tx = (W + TW - 1) / TW, count = B * H * tx, step = gridDim.x;
  const int gx = step % tx, gy = step / tx,
            bytes = B * H * W * G::CIN;  // the u8 frames'
  unsigned char* raw = smem + U::OFF_RAW;
  Walk cur(blockIdx.x, H, tx), ahead = cur;
  uint32_t words[G::NW];
  fetch<R>(x, bytes, ahead.b, ahead.y, ahead.xt * TW, H, W, t, words);
  put_words<R>(raw, t, words);
  ahead.advance(gx, gy, tx, H);
  if (blockIdx.x + step < count)
    fetch<R>(x, bytes, ahead.b, ahead.y, ahead.xt * TW, H, W, t, words);
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
  const unsigned char* a_src = halo + (pa * G::SLOTS + 2 * q) * U::V;
  for (int tile = blockIdx.x, it = 0; tile < count; tile += step, ++it) {
    const int buf = it % NOUT;
    // every thread read the last staged halo before the barrier after
    // its wgmmas, and these raw words were put before the last barrier
    stage<U::F32, R>(halo, raw, smem + U::OFF_ZEROS, table, t, cur.b,
                     cur.y, cur.xt * TW, H, W);
    // this tile's staging buffer was read out by the store NOUT tiles ago
    if (t == 0) bulk_wait_read<NOUT - 1>();
    __syncthreads();
    float acc[32], cor[32];
    mma_row<U::F32, R>(acc, cor, a_src, base + (uint32_t)U::OFF_W);
    unsigned char* st = smem + buf * U::OUT_BYTES;
    epilogue<T, TOut>(st, acc, cor, bi, al, al2, inv_s, pa, q);
    // the next tile's halo words, read a tile ago (every thread is done
    // with the raw buffer: it staged this tile's before the barrier)
    put_words<R>(raw, t, words);
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
      fetch<R>(x, bytes, ahead.b, ahead.y, ahead.xt * TW, H, W, t, words);
    cur.advance(gx, gy, tx, H);
    ahead.advance(gx, gy, tx, H);
  }
  if (t == 0) bulk_wait<0>();  // the stores have read their buffers
}

// B, H, W: the output's (the u8 input is R H x R W).
template <typename T, typename TOut, int R = 1>
cudaError_t launch(const void* x, const void* w, const float* b,
                   const float* a, const float* inv, void* y, int B, int H,
                   int W, cudaStream_t stream) {
  using U = U8<T, TOut, R>;
  const long long tiles = (long long)B * H * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  // the kernel walks tiles and addresses input bytes in int
  if ((long long)B * H * W * Geo<R>::CIN >= (1LL << 31))
    return cudaErrorInvalidValue;
  CUtensorMap out_map;
  cudaError_t err = halo_map(&out_map, U::MAP_TYPE, (int)sizeof(TOut), y, B,
                             H, W, TW, 1, U::SWIZZLE, U::BOX_C);
  if (err != cudaSuccess) return err;
  auto kernel = conv3x3_u8_tc_kernel<T, TOut, R>;
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

// K3 at Cin 12: RRDB x2's conv_first over the 2x2-unshuffled frame, read
// in place.  `x`: (B, 2H, 2W, 3) u8; `w`: the HWIO weights (3, 3, 12, 64)
// in the compute dtype; `alpha` rounded to the compute dtype (RRDB: ones,
// no activation); y: (B, H, W, 64); dtype: 0 = float32, 1 = bfloat16.
extern "C" int reve_conv3x3_u8x2_bias(const void* x, const void* w,
                                      const float* b, const float* alpha,
                                      void* y, int B, int H, int W,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch<bf16, bf16, 2>(x, w, b, alpha, nullptr, y, B, H, W,
                                      s);
  if (dtype == 0)
    return (int)launch<float, float, 2>(x, w, b, alpha, nullptr, y, B, H, W,
                                        s);
  return (int)cudaErrorInvalidValue;
}
