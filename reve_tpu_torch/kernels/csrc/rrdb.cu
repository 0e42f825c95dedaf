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
// registers.  Cin is walked in chunks of 16 channels: a chunk's halo is
// one TMA box of a 4-D map over the first Cin channels of the Cs-channel
// pixels (tc.cuh's halo_map with a channel count and pixel stride), a
// pixel one 32-B row of the A operand in the 32-B swizzle (one k16 step),
// and tap (dy, dx) starts dy * 66 + dx rows later.  Zeros outside the
// frame are SAME padding.  Four halo stages: the halos stream from
// device memory near its rate (the forms at Cout 32 are bound by it), and
// with 16-channel chunks three of them are in flight while the
// warpgroups read the fourth, in the shared memory that two 32-channel
// stages took.  Persistent blocks of 4 consumer warpgroups and a
// producer warpgroup: three of its threads issue the halos, the weights
// and the residuals, each ring in the order the warpgroups consume it
// (setmaxnreg hands the others' registers to the consumers, 112 a
// thread).  The warpgroups release each stage with a predicated arrival
// after the wgmmas that read it are waited on, so no branch on the thread
// index sits between a wgmma and its wait.  Weights are packed
// once per model (kernels/rrdb.py, pack_weights_dense) as [chunk][tap]
// [split][k / 8][n][8] bf16 (B K-major, core matrices of 8 rows x 16 B).
//  * bfloat16: tiles of 8 x 64 pixels, each warpgroup two rows (two
//    accumulator sets, one wgmma group of 18 a chunk), so a chunk's
//    weights serve 512 pixels and its halo, (8+2) x (64+2) pixels, is
//    1.29x the tile (4 x 64 tiles: 1.55x).  At Cout 32 (convs 1-4) the
//    weights of every chunk (at most 12 x 9,216 B) come in once per block
//    and stay resident; at Cout 64 (conv 5, conv_body) they stream a
//    chunk at a time (18,432 B) through four stages.  The
//    epilogue stages the tile's outputs in shared memory (the store
//    map's swizzle, so the fragment's pairs hit 32 banks) and one thread
//    of each warpgroup writes its rows by a TMA store, which drains while
//    the next tile's wgmmas run.  The residual `res` is TMA-loaded into
//    the same staging buffer during the mainloop (once the last tile's
//    stores have read it), and each thread computes over it in place;
//    the RRDB form reads `r` (its output's own pixels) from global
//    memory, a row's loads in flight together.
//  * float32: as float32 K1, six bf16 products of operands split in
//    three (hi.hi in one accumulator set, the five smaller ones in
//    another; never TF32), on the planes (3, B, H, W, Cp) bf16 of the
//    buffer's split: the kernel that wrote a channel wrote its planes
//    too, so no split pass runs before a launch.  Tiles of 4 x 64, one
//    row a warpgroup: two rows would take 128 accumulator registers a
//    thread at Cout 64, and four halo stages of three planes of an 8-row
//    tile 258,048 B.  The weights' splits stream three taps at a time
//    (18,432 B at Cout 64) through three stages.  Each value is written
//    with, where the caller passes planes, its hi, mid and lo (tc.cuh's
//    split2, the split pass's arithmetic, so the planes are bit-identical
//    to its output).  At Cout 32 (convs 1-4, 276 of a call's 346
//    launches) three halo stages leave room to stage a row's values and
//    planes (20,480 B a warpgroup) for TMA stores, as in bfloat16, and
//    the A fragments of the three planes are read into registers
//    (ldmatrix) once for the six products (from shared memory each
//    m64n32k16 reads 2 KB of A for 1 KB of B, more than shared memory
//    delivers in the tensor cores' time for it; a unit of three taps is
//    waited on before its fragments' registers are reused).  At
//    Cout 64 four halo stages of three planes take 215,040 B with the
//    weights, so the epilogue writes from registers: it turns each quad
//    of lanes' pairs around (quad_transpose: a lane then holds 8
//    consecutive channels of its pixel) and writes 16-B vectors; the
//    residuals are read the same way round.
//  * Every output pixel is summed the same way wherever it sits in the
//    frame, with the reference's rounding in the epilogue (__fadd_rn,
//    __fmul_rn, round_to; no FMA contraction).
#include <type_traits>

#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using reve::round_to;
using namespace reve::tc;

constexpr int CK = 16;   // input channels per chunk: one 32-B A row
constexpr int WGS = 4;   // consumer warpgroups
constexpr int TW = 64;   // tile columns: the M of one wgmma
constexpr int THREADS = 128 * (WGS + 1);  // + the producer warpgroup
// registers a thread: __launch_bounds__(THREADS, 1) caps each at 65,536 /
// THREADS rounded down to 8 (96), and launch() refuses a kernel that
// ptxas gave any other count; the producer warpgroup hands most of its
// own to the consumers (without it ptxas spills 700 B a thread in
// float32 at Cout 64).  The consumers' setmaxnreg.inc waits until the
// block's own registers cover it: only what the producer gave up, not
// the SM's unallocated rest (112 with the producer at 40 hung on the
// card, as did 120 at 32), so a budget the block does not hold hangs the
// card instead of failing.
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 112;
static_assert(PRODUCER_REGS + WGS * CONSUMER_REGS <= (WGS + 1) * LAUNCH_REGS,
              "more registers than the block was launched with");
constexpr int MAX_CHUNKS = 12;           // Cin <= 192

enum Epilogue { LRELU = 0, RDB = 1, RRDB = 2, ADD = 3 };

// F32 = false: bf16 operands, one plane, two rows a warpgroup, outputs
// staged for TMA stores; weights resident at N = 32, a chunk a stage at
// N = 64.  F32 = true: three planes (hi, mid, lo), six products, one row
// a warpgroup, a weight stage holds three taps' three splits.
template <bool F32, int N>
struct K7 {
  using T = std::conditional_t<F32, float, bf16>;
  static constexpr int PLANES = F32 ? 3 : 1;
  static constexpr int RPW = F32 ? 1 : 2;  // tile rows a warpgroup
  static constexpr int TH = WGS * RPW;     // tile rows
  static constexpr int HALO_TX = (TH + 2) * (TW + 2) * CK * 2;  // a plane
  static constexpr int HALO_BYTES = (HALO_TX + 1023) / 1024 * 1024;
  // outputs by TMA stores from a staging buffer: bf16, and float32 at
  // N = 32 (its values and their three planes: 81,920 B, for which it
  // keeps three halo stages); float32 at N = 64 stores from registers
  static constexpr bool STAGED = !F32 || N == 32;
  static constexpr int HS = F32 && N == 32 ? 3 : 4;  // halo stages
  static constexpr bool RESIDENT = !F32 && N == 32;
  // float32 at N = 32 reads A into registers (ldmatrix), once for the
  // products of all three weight splits: an m64n32k16 from shared memory
  // reads 2 KB of A for 1 KB of B, more than shared memory gives in the
  // time the tensor cores take for it
  static constexpr bool A_REGS = F32 && N == 32;
  static constexpr int TPS = F32 ? 3 : 9;  // taps per weight stage
  static constexpr int UNITS = 9 / TPS;    // weight stages per chunk
  // weight stages: resident, one per chunk
  static constexpr int WS = RESIDENT ? MAX_CHUNKS : F32 ? 3 : 4;
  static constexpr int SPLIT_BYTES = CK * N * 2;  // one tap, one split
  static constexpr int TAP_BYTES = PLANES * SPLIT_BYTES;
  static constexpr int W_STAGE = TPS * TAP_BYTES;
  static constexpr int HALO_STAGE = PLANES * HALO_BYTES;
  // one staged output row: bf16; float32's values, then hi, mid, lo
  static constexpr int ROW_STAGE = TW * N * (F32 ? 4 + 3 * 2 : 2);
  static constexpr size_t OFF_W = (size_t)HS * HALO_STAGE;
  static constexpr size_t OFF_ST = OFF_W + (size_t)WS * W_STAGE;
  static constexpr size_t OFF_PAR =
      OFF_ST + (STAGED ? (size_t)TH * ROW_STAGE : 0);  // bias
  static constexpr size_t OFF_BAR = OFF_PAR + N * sizeof(float);
  // barriers: HS halo full, HS halo empty, WS weights full, WS empty, the
  // residual's full and empty
  static constexpr size_t SMEM =
      OFF_BAR + (2 * (HS + WS) + 2) * sizeof(uint64_t);
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
  static_assert(OFF_ST % 1024 == 0, "the staging buffer's swizzle");
};

// The products of one k16 step: `a` is the (hi) plane's A operand, `w`
// the tap's (hi) weights.  bf16: one wgmma into `acc`.  float32: mid and
// lo one and two halo buffers and splits later; hi.hi into `acc`, the
// five smaller products into `cor`, smallest first.
template <bool F32, int N>
__device__ __forceinline__ void mma_step(float (&acc)[N / 2],
                                         float (&cor)[N / 2], uint32_t a,
                                         uint32_t w) {
  const uint64_t ah = desc_sw32(a), bh = desc(w, N * 16);
  if constexpr (F32) {
    constexpr int SPLIT = CK * N * 2, HB = K7<F32, N>::HALO_BYTES;
    const uint64_t am = desc_sw32(a + HB), al = desc_sw32(a + 2 * HB);
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

// The six products of one k16 step with A in registers: a[q] the
// fragments of planes hi, mid, lo; `w` the tap's hi weights (mid and lo
// one and two splits later); the order of mma_step's.
template <int N>
__device__ __forceinline__ void mma_step_regs(float (&acc)[N / 2],
                                              float (&cor)[N / 2],
                                              const uint32_t (&a)[3][4],
                                              uint32_t w) {
  constexpr int SPLIT = CK * N * 2;
  const uint64_t bh = desc(w, N * 16), bm = desc(w + SPLIT, N * 16),
                 bl = desc(w + 2 * SPLIT, N * 16);
  Wgmma<N>::mma(cor, a[2], bh);
  Wgmma<N>::mma(cor, a[0], bl);
  Wgmma<N>::mma(cor, a[1], bm);
  Wgmma<N>::mma(cor, a[1], bh);
  Wgmma<N>::mma(cor, a[0], bm);
  Wgmma<N>::mma(acc, a[0], bh);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// A 4 x 4 transpose of 32-bit words within each quad of lanes (lanes 4k
// .. 4k + 3): lane i holds m[j] = M[i][j] on entry and M[j][i] on exit.
// Round r: each lane sends its word (l + r) % 4, which lane (l + r) % 4
// receives from lane (l' - r) % 4 as its word of that lane.
__device__ __forceinline__ void quad_transpose(uint32_t (&m)[4]) {
  const int lane = threadIdx.x & 31, l = lane & 3;
  uint32_t t[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int sj = (l + r) & 3, src = (l - r) & 3;
    const uint32_t send = sj == 0 ? m[0] : sj == 1 ? m[1] : sj == 2 ? m[2]
                                                                    : m[3];
    const uint32_t got = __shfl_sync(0xffffffffu, send, (lane & ~3) | src);
#pragma unroll
    for (int i = 0; i < 4; ++i) t[i] = src == i ? got : t[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = t[i];
}

// 8 float32 channels at p (32-B aligned) as two words per pair: m[0][i],
// m[1][i] the channels 2i and 2i + 1; store8 the other way.
__device__ __forceinline__ void load8(const float* p, uint32_t (&m)[2][4]) {
  const uint4 a = reinterpret_cast<const uint4*>(p)[0],
              b = reinterpret_cast<const uint4*>(p)[1];
  m[0][0] = a.x, m[1][0] = a.y, m[0][1] = a.z, m[1][1] = a.w;
  m[0][2] = b.x, m[1][2] = b.y, m[0][3] = b.z, m[1][3] = b.w;
}
__device__ __forceinline__ void store8(float* p, const uint32_t (&m)[2][4]) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(m[0][0], m[1][0], m[0][1],
                                              m[1][1]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(m[0][2], m[1][2], m[0][3],
                                              m[1][3]);
}

// dtype(dtype(v * s) + x): a residual step of the dense blocks
template <typename T>
__device__ __forceinline__ float scaled_add(float v, float s, float x) {
  return round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(v, s)), x));
}

// The epilogue of one pair of values v (conv + b, cast): the form `epi`
// with the residual pairs x2 (`res`) and r2 (`res2`, the RRDB form).
template <typename T>
__device__ __forceinline__ void epilogue(float (&v)[2], int epi, float k02,
                                         float2 x2, float2 r2) {
  if (epi == LRELU) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      v[e] = v[e] >= 0.f ? v[e] : round_to<T>(__fmul_rn(v[e], k02));
  } else if (epi == ADD) {
    v[0] = round_to<T>(__fadd_rn(x2.x, v[0]));
    v[1] = round_to<T>(__fadd_rn(x2.y, v[1]));
  } else {
    v[0] = scaled_add<T>(v[0], k02, x2.x);
    v[1] = scaled_add<T>(v[1], k02, x2.y);
    if (epi == RRDB) {
      v[0] = scaled_add<T>(v[0], k02, r2.x);
      v[1] = scaled_add<T>(v[1], k02, r2.y);
    }
  }
}

// map: the halo loads (bf16: the Cin channels of the Cs-channel buffer;
// float32: its three planes).  res_map (bfloat16): the tile's `res`
// channels, loaded into the staging buffer; out_map, planes_map (STAGED):
// a warpgroup's output rows and (float32) their planes, stored from it.
// out_planes (float32; may be null): the planes of `out`'s channels,
// pixels op_px values apart, plane after plane.
template <bool F32, int N>
__global__ void __launch_bounds__(THREADS, 1)
dense_conv_kernel(const __grid_constant__ CUtensorMap map,
                  const __grid_constant__ CUtensorMap res_map,
                  const __grid_constant__ CUtensorMap out_map,
                  const __grid_constant__ CUtensorMap planes_map,
                  const bf16* __restrict__ w, const float* __restrict__ bias,
                  const typename K7<F32, N>::T* res, int res_px,
                  const typename K7<F32, N>::T* res2, int res2_px,
                  typename K7<F32, N>::T* out, int out_px,
                  bf16* out_planes, int op_px, int epi, int chunks, int B,
                  int H, int W) {
  using K = K7<F32, N>;
  using T = typename K::T;
  constexpr int RPW = K::RPW, HALO_TX = K::HALO_TX;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;

  float* bs = reinterpret_cast<float*>(smem + K::OFF_PAR);
  for (int i = tid; i < N; i += THREADS) bs[i] = bias[i];
  const uint32_t halo_full = base + (uint32_t)K::OFF_BAR;
  const uint32_t halo_empty = halo_full + 8 * K::HS;
  const uint32_t w_full = halo_empty + 8 * K::HS;
  const uint32_t w_empty = w_full + 8 * K::WS;
  const uint32_t res_full = w_empty + 8 * K::WS;
  const uint32_t res_empty = res_full + 8;
  if (tid == 0) {
    for (int s = 0; s < K::HS; ++s) {
      mbar_init(halo_full + 8 * s, 1);
      mbar_init(halo_empty + 8 * s, WGS);
    }
    for (int s = 0; s < K::WS; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, WGS);
    }
    mbar_init(res_full, 1);
    mbar_init(res_empty, WGS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const TileGrid<K::TH, TW> g(B, H, W);
  // bfloat16 forms with a residual load it into the staging buffer
  const bool has_res = !F32 && epi != LRELU;

  if (wg == WGS) {
    // The producer: the first thread of its warp 0 issues the halos, of
    // warp 1 the weights, of warp 2 the residuals, each in the order the
    // warpgroups consume them, so each ring runs as far ahead as its
    // stages allow.  The gh-th halo (gw-th weight stage) of the block
    // waits for the warpgroups to release the one HS (WS) before it, and
    // the k-th tile's residual for the warpgroups' stores of tile k - 1
    // to have read the staging buffer.
    setmaxnreg_dec<PRODUCER_REGS>();
    const int role = t >> 5;
    if ((t & 31) != 0) return;
    if (role == 0) {
      long long gh = 0;
      for (long long tile = blockIdx.x; tile < g.count; tile += gridDim.x) {
        int b, y0, x0;
        g.origin(tile, b, y0, x0);
        for (int c = 0; c < chunks; ++c, ++gh) {
          const int hs = (int)(gh % K::HS);
          if (gh >= K::HS)
            mbar_wait(halo_empty + 8 * hs, (uint32_t)((gh / K::HS - 1) & 1));
          mbar_expect_tx(halo_full + 8 * hs, K::PLANES * HALO_TX);
          for (int q = 0; q < K::PLANES; ++q)
            tma_load_4d(base + hs * K::HALO_STAGE + q * K::HALO_BYTES,
                        &map, halo_full + 8 * hs, c * CK, x0 - 1, y0 - 1,
                        q * B + b);
        }
      }
    } else if (role == 1 && K::RESIDENT) {
      const uint32_t wbytes = (uint32_t)chunks * K::W_STAGE;
      mbar_expect_tx(w_full, wbytes);
      bulk_load(base + (uint32_t)K::OFF_W, w, wbytes, w_full);
    } else if (role == 1) {
      long long gw = 0;
      for (long long tile = blockIdx.x; tile < g.count; tile += gridDim.x)
        for (int c = 0; c < chunks; ++c)
          for (int u = 0; u < K::UNITS; ++u, ++gw) {
            const int ws = (int)(gw % K::WS);
            if (gw >= K::WS)
              mbar_wait(w_empty + 8 * ws, (uint32_t)((gw / K::WS - 1) & 1));
            mbar_expect_tx(w_full + 8 * ws, K::W_STAGE);
            bulk_load(base + (uint32_t)(K::OFF_W + ws * K::W_STAGE),
                      w + ((long long)c * 9 + u * K::TPS) *
                              (K::TAP_BYTES / 2),
                      K::W_STAGE, w_full + 8 * ws);
          }
    } else if (role == 2 && has_res) {
      int k = 0;
      for (long long tile = blockIdx.x; tile < g.count;
           tile += gridDim.x, ++k) {
        int b, y0, x0;
        g.origin(tile, b, y0, x0);
        if (k > 0) mbar_wait(res_empty, (uint32_t)((k - 1) & 1));
        mbar_expect_tx(res_full, K::TH * K::ROW_STAGE);
        tma_load_4d(base + (uint32_t)K::OFF_ST, &res_map, res_full, 0, x0,
                    y0, b);
      }
    }
    return;
  }

  // The warpgroups: after each group of wgmmas is issued, the group
  // before it is waited on and its stages are released by predicated
  // arrivals (no branch between a wgmma and its wait).
  setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = t & 31;
  const int p0 = (t >> 5) * 16 + (lane >> 2), c0 = (lane & 3) * 2;
  // the warpgroup's first halo row
  const uint32_t row_off = wg * RPW * (TW + 2) * CK * 2;
  // ldmatrix (A_REGS): this lane's row of the warp's 16 and its 16-B half
  const uint32_t lm_off =
      ((t >> 5) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * CK * 2 +
      (lane >> 4) * 16;
  const float k02 = round_to<T>(0.2f);
  if constexpr (K::RESIDENT) mbar_wait(w_full, 0);
  long long gh = 0, gw = 0;
  int k = 0;
  for (long long tile = blockIdx.x; tile < g.count; tile += gridDim.x, ++k) {
    int b, y0, x0;
    g.origin(tile, b, y0, x0);
    float acc[RPW][N / 2], cor[RPW][N / 2];
#pragma unroll
    for (int s = 0; s < RPW; ++s)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[s][i] = cor[s][i] = 0.f;
    for (int c = 0; c < chunks; ++c, ++gh) {
      const int hs = (int)(gh % K::HS);
      mbar_wait(halo_full + 8 * hs, (uint32_t)((gh / K::HS) & 1));
      const uint32_t a_rows = base + hs * K::HALO_STAGE + row_off;
#pragma unroll
      for (int u = 0; u < K::UNITS; ++u, ++gw) {
        uint32_t wst = base + (uint32_t)K::OFF_W;
        if constexpr (K::RESIDENT) {
          wst += c * K::W_STAGE;
        } else {
          const int ws = (int)(gw % K::WS);
          mbar_wait(w_full + 8 * ws, (uint32_t)((gw / K::WS) & 1));
          wst += ws * K::W_STAGE;
        }
#pragma unroll
        for (int s = 0; s < RPW; ++s) {
          fence_regs(acc[s]);
          if constexpr (F32) fence_regs(cor[s]);
        }
        if constexpr (K::A_REGS) {
          // the unit's A fragments, then its wgmmas; waited on before the
          // fragments' registers are free again, and the stages released
          uint32_t af[K::TPS][3][4];
#pragma unroll
          for (int tl = 0; tl < K::TPS; ++tl) {
            const int tap = u * K::TPS + tl;
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              const uint32_t a = a_rows + q * K::HALO_BYTES +
                                 ((tap / 3) * (TW + 2) + tap % 3) * CK * 2 +
                                 lm_off;
              ldmatrix_x4(af[tl][q], a ^ (((a >> 7) & 1) << 4));
            }
          }
          wgmma_fence();
#pragma unroll
          for (int tl = 0; tl < K::TPS; ++tl)
            mma_step_regs<N>(acc[0], cor[0], af[tl],
                             wst + tl * K::TAP_BYTES);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int tl = 0; tl < K::TPS; ++tl)
#pragma unroll
            for (int q = 0; q < 3; ++q) fence_regs(af[tl][q]);
          fence_regs(acc[0]);
          fence_regs(cor[0]);
          mbar_arrive_if(w_empty + 8 * (int)(gw % K::WS), t == 0);
          mbar_arrive_if(halo_empty + 8 * hs, u == K::UNITS - 1 && t == 0);
        } else {
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < RPW; ++s)
#pragma unroll
            for (int tl = 0; tl < K::TPS; ++tl) {
              const int tap = u * K::TPS + tl;
              const uint32_t a =
                  a_rows + ((s + tap / 3) * (TW + 2) + tap % 3) * CK * 2;
              const uint32_t wt = wst + tl * K::TAP_BYTES;
#pragma unroll
              for (int kc = 0; kc < CK / 16; ++kc)
                mma_step<F32, N>(acc[s], cor[s], a + kc * 32,
                                 wt + 2 * kc * N * 16);
            }
          wgmma_commit();
#pragma unroll
          for (int s = 0; s < RPW; ++s) {
            fence_regs(acc[s]);
            if constexpr (F32) fence_regs(cor[s]);
          }
          // the group before this one is done: release its weight stage,
          // and its chunk's halo when it was the chunk's last (u == 0)
          wgmma_wait<1>();
          if constexpr (!K::RESIDENT)
            mbar_arrive_if(w_empty + 8 * (int)((gw + K::WS - 1) % K::WS),
                           (c > 0 || u > 0) && t == 0);
          mbar_arrive_if(halo_empty + 8 * (int)((gh + K::HS - 1) % K::HS),
                         c > 0 && u == 0 && t == 0);
          // the last tile's stores have read the staging buffer: the
          // producer may load this tile's residual into it
          bulk_read_then_arrive_if(res_empty, has_res && k > 0 && c == 0 &&
                                                  u == 0 && t == 0);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < RPW; ++s) {
      fence_regs(acc[s]);
      if constexpr (F32) fence_regs(cor[s]);
    }
    if constexpr (!K::RESIDENT && !K::A_REGS)
      mbar_arrive_if(w_empty + 8 * (int)((gw - 1) % K::WS), t == 0);
    if constexpr (!K::A_REGS)
      mbar_arrive_if(halo_empty + 8 * (int)((gh - 1) % K::HS), t == 0);

    // the epilogue: accumulator fragment register 4j + 2h + e holds pixel
    // 16 * warp + lane / 4 + 8h, channel 8j + 2 * (lane % 4) + e of the
    // warpgroup's row s
    if constexpr (!F32) {
      // the warpgroup's rows of the staging buffer, in the store map's
      // swizzle: the residual where the form has one, then the outputs
      unsigned char* st = smem + K::OFF_ST + wg * RPW * K::ROW_STAGE;
      if (has_res) {
        mbar_wait(res_full, (uint32_t)(k & 1));
      } else {
        if (t == 0) bulk_wait_read<0>();
        warpgroup_sync(wg);
      }
#pragma unroll
      for (int s = 0; s < RPW; ++s) {
        const int oy = y0 + wg * RPW + s;
        const long long row = ((long long)b * H + oy) * W;
        // the RRDB form's r at the row's pairs, all loads in flight
        // together
        __nv_bfloat162 rr[N / 8][2];
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = x0 + p0 + 8 * h;
            rr[j][h] = __floats2bfloat162_rn(0.f, 0.f);
            if (epi == RRDB && oy < H && x < W)
              rr[j][h] = *reinterpret_cast<const __nv_bfloat162*>(
                  res2 + (row + x) * res2_px + 8 * j + c0);
          }
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = p0 + 8 * h, c = 8 * j + c0;
            __nv_bfloat162* sv = reinterpret_cast<__nv_bfloat162*>(
                st + swizzle<N * 2>((s * TW + p) * N * 2 + c * 2));
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v[e] = round_to<T>(__fadd_rn(acc[s][4 * j + 2 * h + e],
                                           bs[c + e]));
            float2 x2 = make_float2(0.f, 0.f);
            if (has_res) x2 = __bfloat1622float2(*sv);
            epilogue<T>(v, epi, k02, x2, __bfloat1622float2(rr[j][h]));
            *sv = __floats2bfloat162_rn(v[0], v[1]);
          }
      }
      // the rows to global memory by one TMA store (clipped at the
      // frame's edges), which drains during the next tile's mainloop
      fence_proxy_async();
      warpgroup_sync(wg);
      if (t == 0) {
        tma_store_4d(&out_map, smem_u32(st), 0, x0, y0 + wg * RPW, b);
        bulk_commit();
      }
    } else if constexpr (K::STAGED) {
      // float32 at N = 32: the row's values and their planes staged in
      // their store maps' swizzles (128-B and 64-B pixels), then stored
      unsigned char* st = smem + K::OFF_ST + wg * K::ROW_STAGE;
      unsigned char* sp = st + TW * N * 4;
      constexpr int PLANE_ROW = TW * N * 2;
      if (t == 0) bulk_wait_read<0>();
      warpgroup_sync(wg);
      const int oy = y0 + wg;
      const long long row = ((long long)b * H + oy) * W;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + 8 * h, c = 8 * j + c0;
          const bool in = oy < H && x0 + p < W;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = 4 * j + 2 * h + e;
            // conv + b in float32 (the compute dtype)
            v[e] = __fadd_rn(__fadd_rn(acc[0][q], cor[0][q]), bs[c + e]);
          }
          float2 x2 = make_float2(0.f, 0.f), r2 = x2;
          if (epi != LRELU && in)
            x2 = load2(res + (row + x0 + p) * res_px + c);
          if (epi == RRDB && in)
            r2 = load2(res2 + (row + x0 + p) * res2_px + c);
          epilogue<T>(v, epi, k02, x2, r2);
          *reinterpret_cast<float2*>(st + swizzle<N * 4>((p * N + c) * 4)) =
              make_float2(v[0], v[1]);
          uint32_t hi, mid, lo;
          split2(v[0], v[1], hi, mid, lo);
          const uint32_t po = swizzle<N * 2>((p * N + c) * 2);
          *reinterpret_cast<uint32_t*>(sp + po) = hi;
          *reinterpret_cast<uint32_t*>(sp + PLANE_ROW + po) = mid;
          *reinterpret_cast<uint32_t*>(sp + 2 * PLANE_ROW + po) = lo;
        }
      fence_proxy_async();
      warpgroup_sync(wg);
      if (t == 0) {
        tma_store_4d(&out_map, smem_u32(st), 0, x0, oy, b);
        if (out_planes != nullptr)
          for (int q = 0; q < 3; ++q)
            tma_store_4d(&planes_map, smem_u32(sp + q * PLANE_ROW), 0, x0,
                         oy, q * B + b);
        bulk_commit();
      }
    } else {
      // quad q of lanes (lane / 4) holds pixels p0 and p0 + 8; each lane
      // 2 channels of every 8.  Turned around, lane l of the quad holds
      // channels 8 (4g + l) .. + 7 of group g (32 channels) of its pixel
      const int l = lane & 3;
      const long long plane = (long long)B * H * W * op_px;
#pragma unroll
      for (int s = 0; s < RPW; ++s) {
        const int oy = y0 + wg * RPW + s;
        if (oy >= H) continue;
        const long long row = ((long long)b * H + oy) * W;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = x0 + p0 + 8 * h;
          const bool in = x < W;
          const long long pix = row + (in ? x : 0);
#pragma unroll
          for (int g = 0; g < N / 32; ++g) {
            const int cl = 8 * (4 * g + l);  // the lane's channels, turned
            // the residuals, 8 channels a lane, turned to the fragment's
            uint32_t x2[2][4] = {}, r2[2][4] = {};
            if (epi != LRELU && in)
              load8(res + pix * res_px + cl, x2);
            if (epi == RRDB && in)
              load8(res2 + pix * res2_px + cl, r2);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              quad_transpose(x2[e]);
              quad_transpose(r2[e]);
            }
            uint32_t o[2][4], hi[4], mid[4], lo[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int j = 4 * g + jj, c = 8 * j + c0;
              float v[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int q = 4 * j + 2 * h + e;
                // conv + b in float32 (the compute dtype)
                v[e] = __fadd_rn(__fadd_rn(acc[s][q], cor[s][q]), bs[c + e]);
              }
              epilogue<T>(v, epi, k02,
                          make_float2(__uint_as_float(x2[0][jj]),
                                      __uint_as_float(x2[1][jj])),
                          make_float2(__uint_as_float(r2[0][jj]),
                                      __uint_as_float(r2[1][jj])));
              o[0][jj] = __float_as_uint(v[0]);
              o[1][jj] = __float_as_uint(v[1]);
              split2(v[0], v[1], hi[jj], mid[jj], lo[jj]);
            }
            quad_transpose(o[0]);
            quad_transpose(o[1]);
            if (in)
              store8(out + pix * out_px + cl, o);
            if (out_planes != nullptr) {
              quad_transpose(hi);
              quad_transpose(mid);
              quad_transpose(lo);
              if (in) {
                bf16* q = out_planes + pix * op_px + cl;
                *reinterpret_cast<uint4*>(q) =
                    make_uint4(hi[0], hi[1], hi[2], hi[3]);
                *reinterpret_cast<uint4*>(q + plane) =
                    make_uint4(mid[0], mid[1], mid[2], mid[3]);
                *reinterpret_cast<uint4*>(q + 2 * plane) =
                    make_uint4(lo[0], lo[1], lo[2], lo[3]);
              }
            }
          }
        }
      }
    }
  }
  // the staging buffer stays until the last stores have read it
  if constexpr (K::STAGED)
    if (t == 0) bulk_wait<0>();
}

template <bool F32, int N>
cudaError_t launch(const void* x, int xs, const void* wp, const float* b,
                   const void* res, int res_px, const void* res2,
                   int res2_px, void* out, int out_px, void* out_planes,
                   int op_px, int epi, int cin, int B, int H, int W,
                   cudaStream_t stream) {
  using K = K7<F32, N>;
  using T = typename K::T;
  if (cin <= 0 || cin % CK || cin > xs || cin / CK > MAX_CHUNKS ||
      epi < LRELU || epi > ADD)
    return cudaErrorInvalidValue;
  const long long tiles =
      (long long)B * ((H + K::TH - 1) / K::TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  // bf16: the Cin channels of the xs-channel buffer; float32: the three
  // planes (3, B, H, W, xs) of its split
  CUtensorMap map, res_map, out_map, planes_map;
  cudaError_t err = halo_map(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x,
                             K::PLANES * B, H, W, TW + 2, K::TH + 2,
                             CU_TENSOR_MAP_SWIZZLE_32B, CK, cin, xs);
  if (err != cudaSuccess) return err;
  res_map = out_map = planes_map = map;
  // the store maps clip at the frame; the residual map reads zeros past
  // it (never stored).  Swizzles by the bytes of a staged pixel.
  const auto swz = [](int bytes) {
    return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_64B;
  };
  if constexpr (!F32) {
    err = halo_map(&out_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, B, H,
                   W, TW, K::RPW, swz(N * 2), N, N, out_px);
    if (err == cudaSuccess && epi != LRELU)
      err = halo_map(&res_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, res, B,
                     H, W, TW, K::TH, swz(N * 2), N, N, res_px);
  } else if constexpr (K::STAGED) {
    err = halo_map(&out_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, B, H,
                   W, TW, K::RPW, swz(N * 4), N, N, out_px);
    if (err == cudaSuccess && out_planes != nullptr)
      err = halo_map(&planes_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                     out_planes, 3 * B, H, W, TW, K::RPW, swz(N * 2), N, N,
                     op_px);
  }
  if (err != cudaSuccess) return err;
  auto kernel = dense_conv_kernel<F32, N>;
  // the registers setmaxnreg redistributes are those the block launched
  // with: any other count than the budget's would hang the card
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs != LAUNCH_REGS) return cudaErrorLaunchOutOfResources;
  int grid = 0;
  err = reve::persistent_grid(kernel, THREADS, K::SMEM, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, K::SMEM, stream>>>(
      map, res_map, out_map, planes_map, static_cast<const bf16*>(wp), b,
      static_cast<const T*>(res), res_px, static_cast<const T*>(res2),
      res2_px, static_cast<T*>(out), out_px, static_cast<bf16*>(out_planes),
      op_px, epi, cin / CK, B, H, W);
  return cudaGetLastError();
}

template <bool F32>
cudaError_t dispatch(const void* x, int xs, const void* wp, const float* b,
                     const void* res, int res_px, const void* res2,
                     int res2_px, void* out, int out_px, void* out_planes,
                     int op_px, int epi, int cin, int cout, int B, int H,
                     int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 32:
      return launch<F32, 32>(x, xs, wp, b, res, res_px, res2, res2_px, out,
                             out_px, out_planes, op_px, epi, cin, B, H, W, s);
    case 64:
      return launch<F32, 64>(x, xs, wp, b, res, res_px, res2, res2_px, out,
                             out_px, out_planes, op_px, epi, cin, B, H, W, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// K7 in bfloat16: `x` the (B, H, W, cs) buffer, of which the conv reads
// channels [0, cin); `wp` the weights packed as [cin / 16][tap][k / 8][n]
// [8]; `out` the first of the cout channels it writes, pixels out_px
// values apart; `res`, `res2` the residuals' first channels (pixels
// res_px, res2_px apart; unused by the forms that do not read them);
// `epi` 0 LRELU, 1 RDB, 2 RRDB, 3 ADD.  Every pointer 16-B aligned and
// every pixel stride a multiple of 8.  Returns a cudaError_t.
extern "C" int reve_dense_conv_tc(const void* x, const void* wp,
                                  const float* b, const void* res,
                                  const void* res2, void* out, int B, int H,
                                  int W, int cin, int cs, int cout,
                                  int res_px, int res2_px, int out_px,
                                  int epi, void* stream) {
  return (int)dispatch<false>(x, cs, wp, b, res, res_px, res2, res2_px, out,
                              out_px, nullptr, 0, epi, cin, cout, B, H, W,
                              stream);
}

// K7 in float32, on the split planes (3, B, H, W, planes_px) bf16 of the
// buffer it reads (channels [0, cin) read), the weights packed as [cin /
// 16][tap][split][k / 8][n][8]; `out_planes` (or null) the first of the
// cout channels of the planes of `out` it writes, pixels out_planes_px
// values apart; the rest as reve_dense_conv_tc.  Returns a cudaError_t.
extern "C" int reve_dense_conv_f32tc_planes(
    const void* planes, const void* wp, const float* b, const void* res,
    const void* res2, void* out, void* out_planes, int B, int H, int W,
    int cin, int planes_px, int cout, int res_px, int res2_px, int out_px,
    int out_planes_px, int epi, void* stream) {
  return (int)dispatch<true>(planes, planes_px, wp, b, res, res_px, res2,
                             res2_px, out, out_px, out_planes, out_planes_px,
                             epi, cin, cout, B, H, W, stream);
}
