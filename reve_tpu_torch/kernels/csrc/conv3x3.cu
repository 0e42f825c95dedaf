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
//  * K3 and K4a take the SRVGG's num_feat C of 32, 64, 96 or 128 output
//    channels (the template's C; K3 at Cin 12 runs at 64): the row's GEMM
//    runs in chunks of NC = 64 output channels (32 where C is not a
//    multiple of 64: m64n32k16), the A fragments read again from the
//    staged halo for each, and the output row is staged and stored as
//    C / BOX_C boxes (64 bf16 channels in the 128-B swizzle, 32 bf16 in
//    the 64-B swizzle at C 32 and 96, 32 float32 in the 128-B; K4a's s8
//    64 channels in the 64-B swizzle, 32 in the 32-B at C 32 and 96).  The
//    numbers below are C = 64's; per call of 4 1080p frames K3's bound in
//    bfloat16 is 0.159, 0.475 and 0.634 ms at 32, 96 and 128, K4a's 0.087,
//    0.245 and 0.324 ms (bytes).
//  * The template's R is the unshuffle factor (Geo<R, TH>): 1 for K3 and
//    K4a (Cin 3), 2 for K3 at Cin 12, whose halo is read in place from
//    the x2 frame (2 u8 rows of 132 pixels for each unshuffled row of
//    66); no unshuffled copy is written.  The numbers below are R = 1's;
//    K3 at Cin 12's follow them.
//  * K3 at Cin 12 (R = 2; K = 108 in 112, 7 k16 steps): staging its
//    halo had cost it more than its wgmmas in bfloat16 (PERF.md: 792
//    (row, pixel) pairs a 64-pixel row, each 3 scattered 2-B or 8-B
//    stores, every unshuffled row staged by the three rows that read
//    it).  So its tiles are TH rows tall (4 in bfloat16, 2 in float32,
//    whose taller halo would leave one block an SM), their halo (TH + 2
//    unshuffled rows) staged once and read by the TH rows in turn, each
//    row with its own wgmmas, epilogue and store; a halo pixel holds its
//    TH + 2 rows x 12 channels, so output row i reads the 36 values of
//    rows i .. i + 2 at 12 i on; and a staging task is one whole
//    unshuffled pixel: its two u8 rows' 6 bytes as the words that hold
//    them, its 12 values, 4 consecutive slots a channel, as 3 8-B (bf16)
//    or 6 16-B (float32) stores.  The k order, the wgmmas and the
//    epilogue are R = 1's, so the output is what the 1-row form wrote,
//    bit for bit.
//  * Blocks of one warpgroup, persistent, several on each SM (U8::BLOCKS,
//    measured), walk tiles of one row of 64 pixels.  Each block packs the
//    HWIO weights once into the B operand in shared memory ([split][k /
//    8][n][8] bf16: 4 KB, 12 KB in float32).
//  * K4a's wide forms in bfloat16 (U8::ROWS: 32, 96 and 128 features, the
//    int8 engine's first conv) had paid a row's fixed costs (its halo
//    loaded and staged, two barriers, a fence, a store) for 2-8 KB of
//    output, every halo row staged three times, and each chunk's wgmma
//    latency before its epilogue (PERF.md: at 128 the stores alone took
//    0.34 ms, the rest 0.28, and they did not overlap).  They run tiles
//    of TH rows (Q8Shape<C>, measured) whose halo is staged once
//    (RowGeo: two copies, so that each row's window starts 4-B aligned),
//    the units (row, chunk) of a row pair unrolled with each unit's
//    wgmmas issued before the epilogue of the unit before it, and the
//    tile's rows leave together, by one TMA store of all C channels (at
//    96 in no swizzle).  The
//    quantize's clip is taken on the bf16 PReLU pairs, at the least bf16
//    whose code is 127 and its negation, so the float32 steps left are
//    the multiply and the rounding add.  The k order, the wgmmas and the
//    epilogue's float32 steps are the one-row form's, so every code is
//    what it wrote.
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
//    adds 1.5 * 2^23 in float32 (common.cuh's quant_bits).
#include <type_traits>

#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace reve::tc;

constexpr int TW = 64;    // tile: one row of 64 pixels, the M of a wgmma
constexpr int THREADS = 128;  // one warpgroup
constexpr int HALO_PX = TW + 2;           // halo pixels of a tile row
// output staging buffers: a tile's store may read its buffer while the
// next NOUT - 1 tiles compute
constexpr int NOUT = 2;

// The halo's geometry at unshuffle factor R for tiles of TH rows and
// staged values of V bytes: the u8 frame is (R H, R W, 3), a conv input
// pixel (y, x) its R x R block, CIN = 3 R^2 channels; a tile's halo is TH
// + 2 conv input rows of 66 pixels.
template <int R, int TH, int V>
struct Geo {
  static constexpr bool PACKED = false;  // B packed by each block
  static constexpr int FACTOR = R;
  static constexpr int CIN = 3 * R * R;    // 3, 12
  static constexpr int HROWS = TH + 2;     // conv input rows of the halo
  // the values an output row reads of a halo pixel: 3 rows x CIN
  // channels (R = 1: 9 + 1 zero)
  static constexpr int WIN = R == 1 ? 10 : 3 * CIN;        // 10, 36
  // halo values a pixel: its HROWS rows x CIN channels (R = 1: WIN), the
  // window of output row i CIN i on; float32's (V 8) padded by 8 zeros,
  // so that the 16-B reads and writes of neighbouring pixels fall 4
  // chunks of 16 B apart in the banks, not on the same ones
  static constexpr int SLOTS =
      R == 1 ? WIN : HROWS * CIN + (V == 8 ? 8 : 0);  // 10; 56, 72
  // K: 3 WIN, padded to whole k16 steps: 27 in 32, 108 in 112
  static constexpr int KP = R == 1 ? 32 : 112;
  static constexpr int KSTEPS = KP / 16;
  // halo values: 66 pixels x SLOTS, and what the last pixel's highest k
  // read past them (zeros)
  static constexpr int HALO_VALS = HALO_PX * SLOTS + (R == 1 ? 12 : 8);
  static constexpr int ROWS = HROWS * R;   // u8 rows of a tile's halo
  static constexpr int ROW_PX = HALO_PX * R;   // u8 pixels of such a row
  // 4-B words read of a halo row: its 198 R bytes from up to 3 bytes
  // into the first (51, 100); a thread reads words t + 128 n
  static constexpr int ROW_WORDS = (ROW_PX * 3 + 6) / 4;
  static constexpr int WORDS = ROWS * ROW_WORDS;      // 153; 800, 1200
  static constexpr int NW = (WORDS + THREADS - 1) / THREADS;  // 2; 7, 10
  // raw buffer rows (R = 2: 16 B past the words, which the last pixel
  // pair's three-word read reaches)
  static constexpr int RAW_ROW = R == 1 ? 256 : 416;
  // staging tasks: R = 1 (u8 row, u8 pixel), 198; R = 2 (halo row, halo
  // pixel), 264 at TH 2, 396 at TH 4
  static constexpr int TASKS = R == 1 ? ROWS * ROW_PX : HROWS * HALO_PX;
  static constexpr int NP = (TASKS + THREADS - 1) / THREADS;   // 2; 3, 4
  static_assert(ROW_WORDS * 4 + (R == 1 ? 0 : 16) <= RAW_ROW,
                "a raw row holds its words (and the last pair's read)");
  static_assert(R == 1 || V != 8 || SLOTS * V / 16 % 8 == 4,
                "float32's neighbouring halo pixels 4 chunks apart");
  // A's highest read: pixel 63's value k 111 of row TH - 1 at dx 2
  static_assert(3 * WIN <= KP &&
                    (TW - 1) * SLOTS + CIN * (TH - 1) + KP +
                            2 * (SLOTS - WIN) <= HALO_VALS,
                "A's reads stay in the halo");
};

// The shape of a wide K4a form (bfloat16 weights at 32, 96 and 128
// features; `U8::ROWS`): TH output rows a tile (its halo staged once, its
// rows stored together by one TMA store of all C channels), BLOCKS on
// each SM, and UNROLL: the tile's row pairs unrolled (1) or looped (0).
// The fastest of those tried on an H100 SXM (perf_conv_tc_parts
// --sources conv3x3.cu, its shape variants; PERF.md section 6, with the
// staged tiles and box widths tried).
template <int TH_, int BLOCKS_, int UNROLL_>
struct RowShape {
  static constexpr int TH = TH_, BLOCKS = BLOCKS_, UNROLL = UNROLL_;
};
template <int C>
struct Q8Shape : RowShape<1, 1, 0> {};  // the forms on one-row tiles
template <>
struct Q8Shape<32> : RowShape<8, 5, 1> {};
template <>
struct Q8Shape<96> : RowShape<4, 4, 1> {};
template <>
struct Q8Shape<128> : RowShape<6, 3, 0> {};

// The halo of a wide K4a tile (R = 1, TH rows): TH + 2 u8 rows of 66
// pixels, staged once.  A halo pixel holds its rows' 3 values each at slot
// 3 r + c of SLOTS, twice: in copy 0 as they are, and in copy 1 one slot
// later, so that output row i's window (3 i on) starts at an even slot of
// copy i % 2 and every A register is one aligned 4-B read.  SLOTS / 2 is 4
// modulo 8: a warp's A reads of k 0..7 and 24..31 fall on distinct banks,
// those of k 8..23, whose tap column changes with q, on two words a bank
// at most (no stride does better).
// The k order is R = 1's (k = 10 dx + 3 dy + c), so a value k of output
// pixel p, row i lies at slot SLOTS (p + dx) + 3 i + k - 10 dx of its
// copy; k 30 and 31 (zero weights) are read at dx 2.
template <int TH>
struct RowGeo {
  // B packed once per set of weights by the wrapper
  // (kernels/conv3x3.py packed_u8conv), each block's copy as it lies
  static constexpr bool PACKED = true;
  static constexpr int FACTOR = 1, CIN = 3, WIN = 10, KP = 32, KSTEPS = 2;
  static constexpr int HROWS = TH + 2, ROWS = HROWS, ROW_PX = HALO_PX;
  static constexpr int ROW_WORDS = (ROW_PX * 3 + 6) / 4;  // 51
  static constexpr int WORDS = ROWS * ROW_WORDS;
  static constexpr int NW = (WORDS + THREADS - 1) / THREADS;
  static constexpr int RAW_ROW = 256;
  // staging tasks: (u8 row, u8 pixel), the pixel fastest
  static constexpr int TASKS = ROWS * ROW_PX;
  static constexpr int NP = (TASKS + THREADS - 1) / THREADS;
  static constexpr int SLOTS = 3 * TH + 10 < 24 ? 24 : 40;
  static constexpr int COPY = HALO_PX * SLOTS;  // values of a copy
  static constexpr int HALO_VALS = 2 * COPY;
  // A's highest read: pixel 63 + 2 at slot 3 (TH - 1) + 1 + 11 + 1 of
  // copy 1
  static_assert(3 * TH + 10 < SLOTS, "A's reads stay in their copy");
  static_assert(SLOTS / 2 % 8 == 4, "A's reads on few banks");
  static_assert(ROW_WORDS * 4 <= RAW_ROW, "a raw row holds its words");
};

// T: the compute dtype (bf16 or float); TOut: T for K3, int8_t for K4a;
// R: the unshuffle factor (Geo); C: the output channels (K3 and K4a: the
// SRVGG's num_feat, 32, 64, 96 or 128; K3 at Cin 12: 64).
template <typename T, typename TOut, int R = 1, int C = 64>
struct U8 {
  // the row's GEMM runs in chunks of NC output channels, one wgmma N each
  // (A's fragments read again for each): 64, or 32 where C is not a
  // multiple of 64
  static constexpr int NC = C % 64 == 0 ? 64 : 32;
  static constexpr int CHUNKS = C / NC;
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr bool Q8 = std::is_same<TOut, int8_t>::value;
  // K4a's wide forms in bfloat16: tiles of S::TH rows (RowGeo), stored a
  // tile at a time
  static constexpr bool ROWS = Q8 && !F32 && C != 64;
  using S = Q8Shape<C>;
  // output rows a tile (R = 2: four in bfloat16, two in float32, whose
  // taller halo would leave room for one block an SM)
  static constexpr int TH = ROWS ? S::TH : R == 1 ? 1 : (F32 ? 2 : 4);
  using G = typename std::conditional<ROWS, RowGeo<TH>,
                                      Geo<R, TH, F32 ? 8 : 2>>::type;
  static constexpr int SPLITS = F32 ? 3 : 1;          // hi (, mid, lo)
  static constexpr int W_BYTES = SPLITS * G::KP * C * 2;
  static constexpr int V = F32 ? 8 : 2;  // a staged value: bf16 (x 3)
  // one staged output row: 8 KB bf16, 16 KB float32, 4 KB s8 at C 64
  static constexpr int OUT_BYTES = TW * C * (int)sizeof(TOut);
  // rows of an output box, and the staged tiles (the wide K4a: one, a
  // tile's rows, written again once its store has read it)
  static constexpr int BOX_H = ROWS ? TH : 1;
  static constexpr int TILE_BYTES = BOX_H * OUT_BYTES;
  static constexpr int TILES = ROWS ? 1 : NOUT;
  static constexpr size_t OFF_W = TILES * TILE_BYTES;  // after the buffers
  static constexpr size_t OFF_RAW = OFF_W + W_BYTES;   // the raw words
  static constexpr size_t OFF_HALO = OFF_RAW + G::ROWS * G::RAW_ROW;
  // the table of a u8 value's staged form: bf16, or bf16 hi | mid, lo
  static constexpr size_t OFF_TABLE = OFF_HALO + G::HALO_VALS * V;
  static constexpr size_t OFF_ZEROS = OFF_TABLE + 256 * V;  // 16 B
  static constexpr size_t SMEM = OFF_ZEROS + 16;
  // the output's tensor map: channels a box holds (128-B rows: 64 bf16,
  // 32 float32; 64-B rows: 64 s8, and 32 bf16 where C is not a multiple
  // of 64; 32-B rows: 32 s8 where C is not a multiple of 64; the wide
  // K4a all C s8, in the 32- and 128-B swizzles at 32 and 128 and none
  // at 96), its swizzle, and the boxes of a staged row
  static constexpr int BOX_C =
      ROWS ? C : F32 && !Q8 ? 32 : (C % 64 == 0 ? 64 : 32);
  static constexpr int BOX_ROW = BOX_C * (int)sizeof(TOut);  // bytes
  static constexpr int NBOX = C / BOX_C;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      BOX_ROW == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
      : BOX_ROW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : BOX_ROW == 96 ? CU_TENSOR_MAP_SWIZZLE_NONE
                      : CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr CUtensorMapDataType MAP_TYPE =
      Q8    ? CU_TENSOR_MAP_DATA_TYPE_UINT8
      : F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // blocks on each SM: the registers must allow them, and no more run
  // (R = 1: the fastest counts on an H100 SXM; perf_conv_tc_parts times
  // one fewer and one more; K4a's wide bf16 forms their shape's, its
  // float32 forms K3's, whose bias and alpha registers grow with C; R =
  // 2: what its A fragments' registers allow, 84 of them in float32)
  static constexpr int BLOCKS = ROWS ? S::BLOCKS :
      Q8 && C != 64 ? (F32 ? 2 : 4) :
      R == 1 ? (F32 ? (Q8 ? 3 : 2) : (Q8 ? 6 : 4)) : (F32 ? 2 : 3);
  // registers a thread: __launch_bounds__(THREADS, BLOCKS) caps each at
  // REGS, so BLOCKS blocks of THREADS fit the SM's 65,536
  static constexpr int REGS = 65536 / (THREADS * BLOCKS) / 8 * 8;
  static_assert(REGS * THREADS * BLOCKS <= 65536,
                "the blocks' registers fit the SM's");
  static_assert(OFF_HALO % 16 == 0 && OFF_TABLE % 16 == 0,
                "16-B aligned halo reads");
  static_assert(C == 64 || R == 1, "K3 at Cin 12 takes 64 output channels");
  static_assert(!ROWS || (SMEM + 1024) * BLOCKS <= 228 * 1024,
                "the blocks' shared memory (and 1 KB each the card "
                "reserves) fit the SM's 228 KB");
  static_assert(!ROWS || TILE_BYTES % 1024 == 0,
                "the wide K4a's staged tile 1-KB aligned, as its swizzle "
                "needs");
};

// The persistent walk over tiles of TH rows of 64 pixels, x fastest:
// image b, row tile y (of H = the image's row tiles), tile column xt,
// advanced by `step` tiles with no division (gx = step % tx, gy = step /
// tx, taken once).
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
template <class G>
__device__ __forceinline__ void fetch(const uint8_t* __restrict__ x,
                                      int bytes, int b, int y0, int x0,
                                      int H, int W, int t,
                                      uint32_t (&v)[G::NW]) {
  constexpr int R = G::FACTOR;
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
template <class G>
__device__ __forceinline__ void put_words(unsigned char* raw, int t,
                                          const uint32_t (&v)[G::NW]) {
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
// (bf16) or 8 B (float32's three splits) a value.
//  * R = 1: the 3 values of u8 row r, pixel u of the halo go to halo
//    pixel u at slot 3 r + c of its 10 (slot 9 zero).  Each thread
//    converts the pairs (r, u) t + 128 n; rows and pixels outside the
//    frame read `zeros`.  A row's first pixel starts s_r % 4 bytes into
//    its first word.
//  * R = 2: task (halo row dy, halo pixel X), t + 128 n with dy fastest
//    (neighbouring threads' stores 12 values apart, not SLOTS), is conv
//    input pixel X of row y0 - 1 + dy: u8 rows 2 (y0 - 1 + dy) + i and u8
//    pixels 2 (x0 - 1 + X) + j, i, j < 2, unshuffled channel 4 c + 2 i +
//    j at slot CIN dy + 4 c + 2 i + j of halo pixel X's SLOTS.  So each c
//    is four consecutive slots, one 8-B (bf16) or two 16-B (float32)
//    stores, and a row's 6 bytes of the pixel pair are read as the 3
//    words that hold them.  Rows and pixels outside the frame are u8 0.
template <bool F32, class G>
__device__ __forceinline__ void stage(unsigned char* halo,
                                      const unsigned char* raw,
                                      const unsigned char* zeros,
                                      const unsigned char* table, int t,
                                      int b, int y0, int x0, int H, int W) {
  using E = typename std::conditional<F32, uint2, unsigned short>::type;
  constexpr int R = G::FACTOR;
  const int HU = R * H, WU = R * W;
  const int s0 = ((b * HU + R * (y0 - 1)) * WU + R * (x0 - 1)) * 3;
  const E* tab = reinterpret_cast<const E*>(table);
#pragma unroll
  for (int n = 0; n < G::NP; ++n) {
    const int m = t + THREADS * n;
    if (m >= G::TASKS) break;
    if constexpr (R == 1) {
      const int r = m / G::ROW_PX, u = m - r * G::ROW_PX;
      const int s = s0 + r * WU * 3;
      const bool in = (unsigned)(y0 - 1 + r) < (unsigned)HU &&
                      (unsigned)(x0 - 1 + u) < (unsigned)WU;
      const unsigned char* src =
          in ? raw + r * G::RAW_ROW + (s & 3) + u * 3 : zeros;
      E* dst = reinterpret_cast<E*>(halo) + u * G::SLOTS + 3 * r;
#pragma unroll
      for (int c = 0; c < 3; ++c) dst[c] = tab[src[c]];
    } else {
      const int X = m / G::HROWS, dy = m - X * G::HROWS;
      const bool in = (unsigned)(y0 - 1 + dy) < (unsigned)H &&
                      (unsigned)(x0 - 1 + X) < (unsigned)W;
      // bytes 0-5 of each row: pixel 2X's channels, then pixel 2X + 1's
      uint32_t lo[2] = {0, 0}, hi[2] = {0, 0};
      if (in) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int o = ((s0 + (2 * dy + i) * WU * 3) & 3) + 6 * X;
          const uint32_t* w = reinterpret_cast<const uint32_t*>(
                                  raw + (2 * dy + i) * G::RAW_ROW) +
                              (o >> 2);
          const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
          lo[i] = __funnelshift_r(w0, w1, 8 * (o & 3));
          hi[i] = __funnelshift_r(w1, w2, 8 * (o & 3));
        }
      }
      E* dst = reinterpret_cast<E*>(halo) + X * G::SLOTS + G::CIN * dy;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        // (i, j) = (0, 0), (0, 1), (1, 0), (1, 1): byte c and 3 + c
        E v[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          v[2 * i] = tab[(lo[i] >> 8 * c) & 0xFF];
          v[2 * i + 1] =
              tab[((c == 0 ? lo[i] >> 24 : hi[i] >> 8 * (c - 1))) & 0xFF];
        }
        if constexpr (F32) {
          uint4* d = reinterpret_cast<uint4*>(dst + 4 * c);
          d[0] = make_uint4(v[0].x, v[0].y, v[1].x, v[1].y);
          d[1] = make_uint4(v[2].x, v[2].y, v[3].x, v[3].y);
        } else {
          *reinterpret_cast<uint2*>(dst + 4 * c) =
              make_uint2(v[0] | (uint32_t)v[1] << 16,
                         v[2] | (uint32_t)v[3] << 16);
        }
      }
    }
  }
}

// Stage a wide K4a tile's raw halo (RowGeo): the 3 values of u8 row r,
// pixel u go to halo pixel u at slots 3 r + c of copy 0 and 3 r + c + 1
// of copy 1, 2 B each.  Each thread converts the pairs (r, u) t + 128 n,
// u fastest; rows and pixels outside the frame read `zeros`.
template <class G>
__device__ __forceinline__ void stage_rows(unsigned char* halo,
                                           const unsigned char* raw,
                                           const unsigned char* zeros,
                                           const unsigned char* table,
                                           int t, int b, int y0, int x0,
                                           int H, int W) {
  const int s0 = ((b * H + y0 - 1) * W + x0 - 1) * 3;
  const unsigned short* tab = reinterpret_cast<const unsigned short*>(table);
#pragma unroll
  for (int n = 0; n < G::NP; ++n) {
    const int m = t + THREADS * n;
    if (m >= G::TASKS) break;
    const int r = m / G::ROW_PX, u = m - r * G::ROW_PX;
    const int s = s0 + r * W * 3;
    const bool in = (unsigned)(y0 - 1 + r) < (unsigned)H &&
                    (unsigned)(x0 - 1 + u) < (unsigned)W;
    const unsigned char* src =
        in ? raw + r * G::RAW_ROW + (s & 3) + u * 3 : zeros;
    unsigned short* dst =
        reinterpret_cast<unsigned short*>(halo) + u * G::SLOTS + 3 * r;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const unsigned short v = tab[src[c]];
      dst[c] = v;
      dst[G::COPY + 1 + c] = v;
    }
  }
}

// A wide K4a row's A fragments (RowGeo), this thread's: register r of k16
// step kc holds pixel pa + 8 (r % 2), k = 16 kc + 8 (r / 2) + 2q + {0,
// 1}; `src` is its row's copy at pixel pa, slot 3 i (+ 1 in copy 1) + 2q,
// and dxo[j] the bytes (SLOTS - 10) dx that k = 8 j + 2q's tap column adds.
template <class G>
__device__ __forceinline__ void a_frags(uint32_t (&a)[G::KSTEPS][4],
                                        const unsigned char* src,
                                        const int (&dxo)[4]) {
#pragma unroll
  for (int kc = 0; kc < G::KSTEPS; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kc][r] = *reinterpret_cast<const uint32_t*>(
          src + ((r & 1) * 8 * G::SLOTS + 16 * kc + 8 * (r >> 1)) * 2 +
          dxo[2 * kc + (r >> 1)]);
}

// Issue one channel chunk's wgmmas of a wide K4a row (bfloat16, A in
// registers, B the chunk's NC columns of the packed weights at `w`) into
// `acc`, and commit them; the caller waits.  The wgmmas are mma_row's.
template <int C, int NC>
__device__ __forceinline__ void issue_row(float (&acc)[NC / 2],
                                          uint32_t (&a)[2][4], uint32_t w) {
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
  // every write of A and of the accumulators comes before the fence
#pragma unroll
  for (int kc = 0; kc < 2; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[kc][r]));
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 2; ++kc)
    Wgmma<NC>::mma(acc, a[kc], desc(w + kc * 32 * C, 16 * C));
  wgmma_commit();
}

// The row's GEMM, this thread's part: the A fragments of all KSTEPS k16
// steps from the staged halo, then the wgmmas, waited on.  With taps
// numbered column by column, k = WIN dx + CIN dy + c (R = 1: 10 dx + 3 dy
// + c), the value k of output pixel p of the tile's row i is halo value
// SLOTS (p + dx) + CIN (i + dy) + c = SLOTS p + CIN i + k + (SLOTS - WIN)
// dx: register r of step kc holds pixel pa + 8 (r % 2), k = 2q + 16 kc +
// 8 (r / 2) + {0, 1}, one aligned read (bf16: 4 B; float32: 16 B, both
// values' hi | mid, lo) from `a_src` (pixel pa, k 2q, row i).  At R = 2
// only k 32..39 crosses a dx (at 36: q >= 2 reads dx 1, `cross` values
// on), and k 108..111 (zero weights) read the values after k 107.
// float32: hi.hi into `acc`, the five smaller products into `cor`,
// smallest first.  B (`w`): NC columns of the C packed, [k / 8][n][8]
// with n < C, started at the chunk's first column.
template <bool F32, class G, int C, int NC>
__device__ __forceinline__ void mma_row(float (&acc)[NC / 2],
                                        float (&cor)[NC / 2],
                                        const unsigned char* a_src,
                                        int cross, uint32_t w) {
  constexpr int KS = G::KSTEPS;
  constexpr int WPLANE = G::KP * C * 2;
  constexpr int V = F32 ? 8 : 2;  // bytes of a staged value
  constexpr int PAD = G::SLOTS - G::WIN;  // 0 at R = 1
  uint32_t a[F32 ? 3 : 1][KS][4];
#pragma unroll
  for (int kc = 0; kc < KS; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k0 = kc * 16 + (r >> 1) * 8;
      const int dx = PAD ? k0 / G::WIN : 0;
      const bool crosses = PAD && k0 % G::WIN + 8 > G::WIN &&
                           k0 + 8 <= 3 * G::WIN;
      const unsigned char* p =
          a_src + ((r & 1) * 8 * G::SLOTS + k0 + PAD * dx) * V +
          (crosses ? cross : 0);
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
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
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
    for (int i = 0; i < NC / 2; ++i) cor[i] = 0.f;
    fence_regs(cor);
  }
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) {
    // B of step kc: k blocks 2kc, 2kc + 1, 16 C B apart
    const uint32_t wb = w + kc * 32 * C;
    if constexpr (F32) {
      const uint64_t bh = desc(wb, 16 * C), bm = desc(wb + WPLANE, 16 * C),
                     bl = desc(wb + 2 * WPLANE, 16 * C);
      Wgmma<NC>::mma(cor, a[2][kc], bh);
      Wgmma<NC>::mma(cor, a[0][kc], bl);
      Wgmma<NC>::mma(cor, a[1][kc], bm);
      Wgmma<NC>::mma(cor, a[1][kc], bh);
      Wgmma<NC>::mma(cor, a[0][kc], bm);
      Wgmma<NC>::mma(acc, a[0][kc], bh);
    } else {
      Wgmma<NC>::mma(acc, a[0][kc], desc(wb, 16 * C));
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);  // keep every read of the accumulators below the wait
  if constexpr (F32) fence_regs(cor);
}

// The epilogue of this thread's accumulators of channel chunk `ci` into
// the staging buffer `st`, in the swizzle of the output's tensor map.
// Register 4j + 2h + e holds pixel pa + 8h, channel 8 jc + 2q + e, jc =
// ci NC / 8 + j; bi, al (float32) and al2 (bf16 pairs) hold the bias and
// alpha of the thread's channels of all chunks; clip_hi and clip_lo the
// wide K4a's clip.
template <typename T, typename TOut, int C>
__device__ __forceinline__ void epilogue(
    unsigned char* st, const float (&acc)[U8<T, TOut, 1, C>::NC / 2],
    const float (&cor)[U8<T, TOut, 1, C>::NC / 2], const float (&bi)[C / 4],
    const float (&al)[C / 4], const __nv_bfloat162 (&al2)[C / 8], float inv,
    int pa, int q, int ci, __nv_bfloat162 clip_hi = __nv_bfloat162(),
    __nv_bfloat162 clip_lo = __nv_bfloat162()) {
  using U = U8<T, TOut, 1, C>;
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int jj = 0; jj < U::NC / 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = ci * (U::NC / 8) + jj;  // the channel group
      const int p = pa + 8 * h, r = 4 * jj + 2 * h;
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
        __nv_bfloat162 pr =
            __hfma2(al2[j], __hmin2(f, zero), __hmax2(f, zero));
        // the wide K4a: the quantize's clip here, on bf16 pairs
        if constexpr (U::ROWS) pr = __hmax2(__hmin2(pr, clip_hi), clip_lo);
        hb = *reinterpret_cast<const uint32_t*>(&pr);
        v[0] = __uint_as_float(hb << 16);
        v[1] = __uint_as_float(hb & 0xFFFF0000u);
      }
      if constexpr (U::ROWS) {
        // the wide K4a's rows of C s8 in their swizzle (none at 96):
        // 16-B chunk c of pixel p at c ^ ((p C / 128) % (C / 16))
        const int sw = U::SWIZZLE == CU_TENSOR_MAP_SWIZZLE_NONE
                           ? 0
                           : (p * C >> 7) & (C / 16 - 1);
        // (clipped above: quant_bits without its clip)
        *reinterpret_cast<uint16_t*>(st + p * C + (((j >> 1) ^ sw) << 4) +
                                     8 * (j & 1) + 2 * q) =
            (uint16_t)__byte_perm(
                __float_as_uint(__fadd_rn(__fmul_rn(v[0], inv), 12582912.f)),
                __float_as_uint(__fadd_rn(__fmul_rn(v[1], inv), 12582912.f)),
                0x40);
      } else if constexpr (U::Q8 && U::BOX_C == 64) {
        // boxes of 64 channels, 64-B rows; 16-B chunk c of pixel p at
        // chunk c ^ ((p / 2) % 4)
        *reinterpret_cast<uint16_t*>(
            st + (j >> 3) * (TW * 64) + p * 64 +
            ((((j >> 1) & 3) ^ ((p >> 1) & 3)) << 4) + 8 * (j & 1) + 2 * q) =
            (uint16_t)__byte_perm(reve::quant_bits(v[0], inv),
                                  reve::quant_bits(v[1], inv), 0x40);
      } else if constexpr (U::Q8) {
        // boxes of 32 channels, 32-B rows; chunk c of pixel p at chunk c ^
        // ((p / 4) % 2)
        *reinterpret_cast<uint16_t*>(
            st + (j >> 2) * (TW * 32) + p * 32 +
            ((((j >> 1) & 1) ^ ((p >> 2) & 1)) << 4) + 8 * (j & 1) + 2 * q) =
            (uint16_t)__byte_perm(reve::quant_bits(v[0], inv),
                                  reve::quant_bits(v[1], inv), 0x40);
      } else if constexpr (U::F32) {
        // boxes of 32 channels, each 128-B rows; chunk c of pixel p at
        // chunk c ^ (p % 8)
        *reinterpret_cast<float2*>(
            st + (j >> 2) * (TW * 128) + p * 128 +
            (((2 * (j & 3) + (q >> 1)) ^ (p & 7)) << 4) + (q & 1) * 8) =
            make_float2(v[0], v[1]);
      } else if constexpr (U::BOX_C == 64) {
        // boxes of 64 channels, 128-B rows
        *reinterpret_cast<uint32_t*>(st + (j >> 3) * (TW * 128) + p * 128 +
                                     (((j & 7) ^ (p & 7)) << 4) + 4 * q) = hb;
      } else {
        // boxes of 32 channels, 64-B rows; chunk c of pixel p at chunk c ^
        // ((p / 2) % 4)
        *reinterpret_cast<uint32_t*>(st + (j >> 2) * (TW * 64) + p * 64 +
                                     (((j & 3) ^ ((p >> 1) & 3)) << 4) +
                                     4 * q) = hb;
      }
    }
}

// The block's B operand, packed from the HWIO weights (3, 3, CIN, C) in
// the compute dtype: [split][k / 8][n][8] bf16 (core matrices of 8 rows x
// 16 B, K-major), tap (dy, dx), channel c at k = WIN dx + CIN dy + c and
// zeros at the other k (R = 1: 9, 19, 29..31; R = 2: 108..111;
// kernels/conv3x3.py pack_weights_u8conv is its reference); float32 as
// its bf16 hi, mid, lo, one split a plane.  Packed here, once a block,
// not by the wrapper: the small torch ops of a packing took longer than
// a tenth of the kernel.  The wide K4a (G::PACKED) takes B packed once
// per set of weights and copies it (packing it in each block took 2.4-
// 2.5% of its call: PERF.md).
template <typename T, class G, int C>
__device__ __forceinline__ void pack_weights(bf16* ws,
                                             const T* __restrict__ w,
                                             int t) {
  constexpr int KP = G::KP, CIN = G::CIN;
  if constexpr (G::PACKED) {
    for (int i = t; i < KP * C / 8; i += THREADS)
      reinterpret_cast<uint4*>(ws)[i] =
          __ldg(reinterpret_cast<const uint4*>(w) + i);
  } else {
    for (int i = t; i < KP * C; i += THREADS) {
      const int k = i / C, n = i - k * C;
      const int dx = k / G::WIN, s = k - G::WIN * dx;  // s = CIN dy + c
      const float v =
          dx < 3 && s < 3 * CIN
              ? reve::to_float(
                    w[((s / CIN * 3 + dx) * CIN + s % CIN) * C + n])
              : 0.f;
      const int at = ((k >> 3) * C + n) * 8 + (k & 7);
      const bf16 hi = __float2bfloat16_rn(v);
      ws[at] = hi;
      if constexpr (std::is_same<T, float>::value) {
        const float r = __fsub_rn(v, __bfloat162float(hi));
        const bf16 mid = __float2bfloat16_rn(r);
        ws[KP * C + at] = mid;
        ws[2 * KP * C + at] =
            __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid)));
      }
    }
  }
}

// B, H, W: the output's; x is (B, R H, R W, 3).
template <typename T, typename TOut, int R, int C>
__global__ void __launch_bounds__(THREADS, U8<T, TOut, R, C>::BLOCKS)
conv3x3_u8_tc_kernel(const __grid_constant__ CUtensorMap out_map,
                     const uint8_t* __restrict__ x,
                     const T* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ alpha,
                     const float* __restrict__ inv, int B, int H, int W) {
  using U = U8<T, TOut, R, C>;
  using G = typename U::G;
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
  pack_weights<T, G, C>(reinterpret_cast<bf16*>(smem + U::OFF_W), w, t);
  fence_proxy_async();
  __syncthreads();

  // the grid never exceeds the tile count; each block walks its tiles
  // `step` apart and reads the halo words of the tile after next
  constexpr int TH = U::TH;
  const int tx = (W + TW - 1) / TW, ty = (H + TH - 1) / TH;
  const int count = B * ty * tx, step = gridDim.x;
  const int gx = step % tx, gy = step / tx,
            bytes = B * H * W * G::CIN;  // the u8 frames'
  unsigned char* raw = smem + U::OFF_RAW;
  Walk cur(blockIdx.x, ty, tx), ahead = cur;
  uint32_t words[G::NW];
  fetch<G>(x, bytes, ahead.b, ahead.y * TH, ahead.xt * TW, H, W, t, words);
  put_words<G>(raw, t, words);
  ahead.advance(gx, gy, tx, ty);
  if (blockIdx.x + step < count)
    fetch<G>(x, bytes, ahead.b, ahead.y * TH, ahead.xt * TW, H, W, t,
             words);
  ahead.advance(gx, gy, tx, ty);
  __syncthreads();
  // this thread's channels 8j + 2q + e: bias, and alpha as the dtype
  // rounds it (the wrapper rounds it, so the bf16 pairs are exact)
  float bi[C / 4], al[C / 4];
  __nv_bfloat162 al2[C / 8];
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bi[2 * j + e] = bias[8 * j + 2 * q + e];
      al[2 * j + e] = alpha[8 * j + 2 * q + e];
    }
    al2[j] = __floats2bfloat162_rn(al[2 * j], al[2 * j + 1]);
  }
  const float inv_s = U::Q8 ? *inv : 0.f;
  // pixel pa, k 2q; past the dx that k 32..39 crosses at R = 2
  const unsigned char* a_src = halo + (pa * G::SLOTS + 2 * q) * U::V;
  const int cross = 2 * q >= G::WIN % 8 ? (G::SLOTS - G::WIN) * U::V : 0;
  if constexpr (U::ROWS) {
    // The wide K4a: a tile's TH rows from its halo staged once, row i
    // from copy i % 2, each row's CHUNKS chunks in turn, the units (row,
    // chunk) of a row pair unrolled: each unit's wgmmas are issued before
    // the epilogue of the unit before it (two accumulator sets, and two A
    // sets, one a row of the pair).  The tile's rows are staged together
    // and leave by one TMA store a box.
    int dxo[4];  // bytes that the tap column of k = 8 j + 2q adds
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dx = (8 * j + 2 * q) / G::WIN;
      dxo[j] = (G::SLOTS - G::WIN) * (dx < 2 ? dx : 2) * 2;
    }
    // the quantize's clip, on the bf16 PReLU output: HI, the least bf16
    // whose code is 127 (fl(HI inv) > 126.5, and below 127.5, a bf16 step
    // above a value that is not), and -HI.  Codes of values within them
    // need no float32 clip, and those past them are +-127, as clipped.
    uint32_t hi = 0x7F80;  // +inf: a code past every finite value
    for (uint32_t lo = 0; lo < hi;) {
      const uint32_t mid = (lo + hi) >> 1;
      if (__fmul_rn(__uint_as_float(mid << 16), inv_s) > 126.5f) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    const __nv_bfloat162 clip_hi = __halves2bfloat162(
        __ushort_as_bfloat16((unsigned short)hi),
        __ushort_as_bfloat16((unsigned short)hi));
    const __nv_bfloat162 clip_lo = __hneg2(clip_hi);
    constexpr int UNITS = 2 * U::CHUNKS;  // of a row pair
    static_assert(TH % 2 == 0, "rows in pairs");
    for (int tile = blockIdx.x; tile < count; tile += step) {
      const int y0 = cur.y * TH;
      stage_rows<G>(halo, raw, smem + U::OFF_ZEROS, table, t, cur.b, y0,
                    cur.xt * TW, H, W);
      // the staged tile was read out by the last tile's store
      if (t == 0) bulk_wait_read<0>();
      __syncthreads();
      unsigned char* st = smem;
      uint32_t a[2][G::KSTEPS][4];
      float acc[2][U::NC / 2];
      // the units of the row pair i, i + 1
      auto pair = [&](int i) {
        a_frags<G>(a[0], a_src + 3 * i * 2, dxo);
        issue_row<C, U::NC>(acc[0], a[0], base + (uint32_t)U::OFF_W);
#pragma unroll
        for (int v = 0; v < UNITS; ++v) {
          // the pair's next unit's wgmmas (none in flight past the pair:
          // a wgmma carried across the loop made ptxas wait more)
          const int n = v + 1;
          if (n < UNITS) {
            if (n == U::CHUNKS)
              a_frags<G>(a[1], a_src + (G::COPY + 3 * i + 4) * 2, dxo);
            issue_row<C, U::NC>(
                acc[n % 2], a[n / U::CHUNKS],
                base + (uint32_t)(U::OFF_W + n % U::CHUNKS * U::NC * 16));
            wgmma_wait<1>();
          } else {
            wgmma_wait<0>();
          }
          fence_regs(acc[v % 2]);  // its reads below the wait
          epilogue<T, TOut, C>(st + (i + v / U::CHUNKS) * TW * C,
                               acc[v % 2], acc[v % 2], bi, al, al2, inv_s,
                               pa, q, v % U::CHUNKS, clip_hi, clip_lo);
        }
      };
      if constexpr (U::S::UNROLL) {
#pragma unroll
        for (int i = 0; i < TH; i += 2) pair(i);
      } else {
#pragma unroll 1
        for (int i = 0; i < TH; i += 2) pair(i);
      }
      // the next tile's halo words, read a tile ago (every thread staged
      // this tile's from the raw buffer before the barrier)
      put_words<G>(raw, t, words);
      fence_proxy_async();  // the staged rows become visible to TMA
      __syncthreads();
      if (t == 0) {
        tma_store_4d(&out_map, base, 0, cur.xt * TW, y0, cur.b);
        bulk_commit();
      }
      // the words of the tile after next, after the fence (it waits for
      // every load in flight)
      if (tile + 2 * step < count)
        fetch<G>(x, bytes, ahead.b, ahead.y * TH, ahead.xt * TW, H, W, t,
                 words);
      cur.advance(gx, gy, tx, ty);
      ahead.advance(gx, gy, tx, ty);
    }
  }
  // the one-row tiles (no tile in the wide K4a's instantiations)
  for (int tile = blockIdx.x, it = 0; !U::ROWS && tile < count;
       tile += step) {
    const int y0 = cur.y * TH;
    // every thread read the last staged halo before the barrier after
    // its wgmmas, and these raw words were put before the last barrier
    stage<U::F32, G>(halo, raw, smem + U::OFF_ZEROS, table, t, cur.b, y0,
                     cur.xt * TW, H, W);
    // the tile's rows, each from the one staged halo (its window CIN i
    // values into each halo pixel)
#pragma unroll 1
    for (int i = 0; i < TH && y0 + i < H; ++i, ++it) {
      const int buf = it % NOUT;
      // this row's staging buffer was read out by the store NOUT rows ago
      if (t == 0) bulk_wait_read<NOUT - 1>();
      __syncthreads();
      unsigned char* st = smem + buf * U::OUT_BYTES;
#pragma unroll
      for (int ci = 0; ci < U::CHUNKS; ++ci) {
        float acc[U::NC / 2], cor[U::NC / 2];
        mma_row<U::F32, G, C, U::NC>(
            acc, cor, a_src + G::CIN * i * U::V, cross,
            base + (uint32_t)(U::OFF_W + ci * U::NC * 16));
        epilogue<T, TOut, C>(st, acc, cor, bi, al, al2, inv_s, pa, q, ci);
      }
      // the next tile's halo words, read a tile ago (every thread is
      // done with the raw buffer: it staged this tile's before the
      // barrier)
      if (i == 0) put_words<G>(raw, t, words);
      fence_proxy_async();  // the staged row becomes visible to TMA
      __syncthreads();
      if (t == 0) {
        const uint32_t src = base + buf * U::OUT_BYTES;
#pragma unroll
        for (int k = 0; k < U::NBOX; ++k)
          tma_store_4d(&out_map, src + k * TW * U::BOX_ROW, k * U::BOX_C,
                       cur.xt * TW, y0 + i, cur.b);
        bulk_commit();
      }
      // the words of the tile after next: the fence above waits for
      // every load in flight, so they are read after it
      if (i == 0 && tile + 2 * step < count)
        fetch<G>(x, bytes, ahead.b, ahead.y * TH, ahead.xt * TW, H, W, t,
                 words);
    }
    cur.advance(gx, gy, tx, ty);
    ahead.advance(gx, gy, tx, ty);
  }
  if (t == 0) bulk_wait<0>();  // the stores have read their buffers
}

// B, H, W: the output's (the u8 input is R H x R W).
template <typename T, typename TOut, int R = 1, int C = 64>
cudaError_t launch(const void* x, const void* w, const float* b,
                   const float* a, const float* inv, void* y, int B, int H,
                   int W, cudaStream_t stream) {
  using U = U8<T, TOut, R, C>;
  const long long tiles =
      (long long)B * ((H + U::TH - 1) / U::TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  // the kernel walks tiles and addresses input bytes in int
  if ((long long)B * H * W * U::G::CIN >= (1LL << 31))
    return cudaErrorInvalidValue;
  CUtensorMap out_map;
  cudaError_t err = halo_map(&out_map, U::MAP_TYPE, (int)sizeof(TOut), y, B,
                             H, W, TW, U::BOX_H, U::SWIZZLE, U::BOX_C, C);
  if (err != cudaSuccess) return err;
  auto kernel = conv3x3_u8_tc_kernel<T, TOut, R, C>;
  int grid = 0;
  err = reve::persistent_grid(kernel, THREADS, U::SMEM, tiles, &grid,
                              U::BLOCKS);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, U::SMEM, stream>>>(
      out_map, static_cast<const uint8_t*>(x), static_cast<const T*>(w), b, a,
      inv, B, H, W);
  return cudaGetLastError();
}

// K3 (Q8 false: the output in the compute dtype) or K4a (Q8: s8) at C
// output channels, in the compute dtype `dtype` (0 = float32, 1 =
// bfloat16).
template <bool Q8, int C>
cudaError_t launch_c(const void* x, const void* w, const float* b,
                     const float* alpha, const float* inv, void* y, int B,
                     int H, int W, int dtype, cudaStream_t s) {
  using OutBf16 = typename std::conditional<Q8, int8_t, bf16>::type;
  using OutF32 = typename std::conditional<Q8, int8_t, float>::type;
  if (dtype == 1)
    return launch<bf16, OutBf16, 1, C>(x, w, b, alpha, inv, y, B, H, W, s);
  if (dtype == 0)
    return launch<float, OutF32, 1, C>(x, w, b, alpha, inv, y, B, H, W, s);
  return cudaErrorInvalidValue;
}

// ... at `feat` (32, 64, 96 or 128) output channels.
template <bool Q8>
int launch_feat(const void* x, const void* w, const float* b,
                const float* alpha, const float* inv, void* y, int B, int H,
                int W, int dtype, int feat, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat) {
    case 32:
      return (int)launch_c<Q8, 32>(x, w, b, alpha, inv, y, B, H, W, dtype, s);
    case 64:
      return (int)launch_c<Q8, 64>(x, w, b, alpha, inv, y, B, H, W, dtype, s);
    case 96:
      return (int)launch_c<Q8, 96>(x, w, b, alpha, inv, y, B, H, W, dtype, s);
    case 128:
      return (int)launch_c<Q8, 128>(x, w, b, alpha, inv, y, B, H, W, dtype,
                                    s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K3.  `w`: the HWIO weights (3, 3, 3, feat) in the compute dtype; `alpha`
// rounded to the compute dtype; dtype: 0 = float32, 1 = bfloat16; feat:
// the output channels, 32, 64, 96 or 128.  Returns a cudaError_t (0 =
// success).
extern "C" int reve_conv3x3_u8_bias_prelu(const void* x, const void* w,
                                          const float* b, const float* alpha,
                                          void* y, int B, int H, int W,
                                          int dtype, int feat, void* stream) {
  return launch_feat<false>(x, w, b, alpha, nullptr, y, B, H, W, dtype, feat,
                            stream);
}

// K4a: K3 with the s8 quantize epilogue; `inv` is a device pointer to
// float32(1 / act_scale[0]); feat: the output channels, 32, 64, 96 or
// 128.
extern "C" int reve_conv3x3_u8_bias_prelu_q8(const void* x, const void* w,
                                             const float* b,
                                             const float* alpha,
                                             const float* inv, void* y, int B,
                                             int H, int W, int dtype,
                                             int feat, void* stream) {
  return launch_feat<true>(x, w, b, alpha, inv, y, B, H, W, dtype, feat,
                           stream);
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
