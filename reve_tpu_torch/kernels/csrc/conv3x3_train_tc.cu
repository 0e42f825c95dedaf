// T1 conv3x3_fwd_train, T2 conv3x3_dgrad and T3 conv3x3_wgrad, SRVGG's
// training convs, in float32 on the tensor cores as six bf16 products
// ("bf16x6").
//
//   T1  z = conv3x3(x, W) + b; with a PReLU after it y = PReLU(z), and z
//       written beside y when asked (the head has no PReLU: y = z)
//   T2  dx = conv3x3^T(dz, W) (W rotated 180 degrees, in and out
//       swapped), times the previous layer's PReLU'(z), and that layer's
//       d(alpha) = sum dx * min(z, 0) as per-tile partial sums that a
//       second kernel (sum_parts) adds in tile order
//   T3  dW[ky, kx, ci, co] = sum_p x(p + k) dz(p), db = sum_p dz(p), over
//       pixel splits whose partial sums sum_parts adds in split order
//
// Replaces (TPU side): reve_tpu/models/srvgg.py:88-113 (`_conv3x3` at
// Precision.HIGHEST and `_prelu`) as reve_tpu/train/trainer.py:66 runs it
// under jax.value_and_grad: XLA's forward conv (T1) and the input (T2)
// and weight (T3) gradients its autodiff derives from it.  PReLU's
// derivative at z = 0 is JAX's (1 + alpha) / 2 (lax.max and lax.min split
// a tie's gradient in halves), and d(alpha) there is 0.
//
// Scheme (float32 K1's, conv3x3_f32_tc.cu): each float32 operand splits
// into bf16 hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid),
// each subtraction exact; the six products hi.hi, hi.mid, mid.hi, hi.lo,
// lo.hi and mid.mid (those left out lie below 2^-24 of the result) are
// summed on bf16 wgmma with float32 accumulators, hi.hi in one register
// set and the five smaller products in another, added in float32 in the
// epilogue: the tensor cores add in their own order and may truncate, so
// the large sum takes one truncating step a k16 step, not six.  That is
// how XLA computes a float32 Precision.HIGHEST product on the TPU.  No
// TF32, no float atomics: T1's every output and T3's every partial is one
// fixed sequence of wgmmas, so a training step repeats bit for bit.
//
// Bound on an H100 SXM at a step's 8 x 64 x 64 pixels: the conv is 9 Cin
// Cout 32,768 x 2 operations, 2.416 GFLOP at 64 -> 64 and 9.66 GFLOP at
// 128 -> 128; as six bf16 products at 989 TFLOP/s 0.0147 and 0.0586 ms
// (float32 FMAs at 67 TFLOP/s: 0.036 and 0.144 ms); the bytes (about 25
// and 50 MB) take 0.0075 and 0.015 ms, so all three kernels are bound by
// their operations.
//
// Design.  What held the CUDA-core forms back (float32 FMAs, a
// single-buffered 8-deep K step, T3's pixel decode a K step and x read
// once a tap row, db as an extra tile row, 16 MB of partial sums, T2's
// weights read transposed one float a thread) and what this file does
// about it:
//  * Both are implicit GEMMs on m64nNk16 wgmma with every operand staged
//    in shared memory as its three bf16 planes.  The threads that stage
//    an operand load it as float32 (two 16-B loads: 8 channels of one
//    pixel), split it in registers (tc.cuh's split2) and store the three
//    planes: no split pass runs anywhere in the step.  A pixel's 64
//    channels are one 128-B row in the 128-B swizzle (the layout TMA
//    writes for K1), so a tap's shift is a start moved by whole rows.
//  * T1 and T3 issue the next operand's global loads before the proxy
//    fence and barrier that precede the current one's wgmmas, and consume
//    them after those: the fence waits for a thread's loads in flight, so
//    their latency does not hide behind the tensor cores (T2 issues its
//    weights after its wgmmas instead).  The split and the stores run
//    between two barriers, never between a wgmma and its wait.
//  * T1 (M = a row of 64 pixels a warpgroup, N = Cout, K = 9 Cin): a
//    block takes 2 rows x 64 pixels (two warpgroups) and one N block (64,
//    or 48: Wgmma<48> for the head; Cout 128 as two blocks).  The halo
//    (4 x 66 pixels of a 64-channel half) is the K-major A operand in the
//    128-B swizzle; the HWIO weights are read as they lie, 32 input
//    channels of one tap at a time, and stored K-major without swizzle
//    ([k / 8][n][8], float32 K1's packed layout): a thread reads one
//    column's 8 consecutive k (coalesced along n across the warp) and
//    writes them as one 16-B row of each plane.  Cin 3 takes K = 27 in 32
//    (one unit) from an im2col of the tile's pixels, k = 3 tap + c, the
//    weights' own order.  113,664 B of shared memory: two blocks an SM,
//    so one block's staging overlaps the other's wgmmas.  The epilogue
//    keeps the CUDA-core form's rounding: + b with __fadd_rn (after acc +
//    cor), PReLU as z > 0 ? z : alpha z, z beside y only when asked.
//  * T2 is T1's GEMM with dz in place of x (M = a row of 64 pixels a
//    warpgroup, N = Cin, K = 9 Cout) and the taps mirrored: output pixel
//    q reads dz(q - o_t), o_t = (ky - 1, kx - 1), so tap t's A starts at
//    halo row wg + 2 - ky, column 2 - kx, whole 128-B rows as in T1.  B is
//    B[k = co][n = ci] = W[t][ci][co]: HWIO's innermost index is Cout,
//    T2's K, so a (tap, ci) row's 8 consecutive co are one 32-B load of
//    one column's K run, staged [k / 8][n][8] as T1's weights; no
//    transpose.  N is Cin in 64-channel blocks (Cin 128 as two; Cin 3 at
//    wgmma's N 8, columns 3-7 zero).  Cout 48 runs its odd units with
//    dz's channels 48-63 staged as zeros and never read (a 16-B load
//    there would read the next pixel).  The epilogue adds acc + cor in
//    T1's order, reads z_prev at the accumulator fragment's positions
//    (two adjacent channels a thread per 8-column group), writes dz_prev
//    = PReLU'(z_prev) dx and sums d(alpha) per column over the thread's
//    pixels, then over the 8 lanes of a column (shuffles) and the 8 warps
//    (in warp order): one partial row a tile, summed by sum_parts in
//    tile order.  Same shared memory and occupancy as T1: two blocks an
//    SM.  Unlike T1, T2 issues a unit's next weights after its wgmmas,
//    not before the proxy fence: that fence waits for the thread's loads
//    in flight, so loads issued before it hide nothing (T2 by parts,
//    PERF.md).
//  * T3 (M = 64 rows of dW, N = 64 output channels, K = pixels): both
//    operands are MN-major (K, the pixel, is the outer index of x and dz),
//    read by wgmma with its transpose flags from the same 128-B-swizzled
//    pixel rows.  A block of three warpgroups takes one tap row dy, one
//    64-channel half of Cin and one N block, each warpgroup one tap dx of
//    the row: the three slabs are shifts of one staged x tile (2 rows x
//    66 pixels), so the input is decoded once a tile and read three times
//    from L2 for the nine taps, and dz once a tap row.  Cin 3's 27 rows
//    (3 tap + c) fill one slab, staged as an im2col by two warpgroups, one
//    of which runs the wgmmas.  Cout 48 runs at N = 64 with dz's channels
//    48-63 staged as zeros.  db is summed apart, in float32, by the
//    threads that stage dz in one block of each N block (the tap row dy =
//    0, the first half): each thread sums its fixed 8 channels over its
//    pixels, and the block adds the threads' sums in thread order.  No
//    tile holds db alone.  A split sums thousands of pixels, so hi.hi's
//    accumulators are added into a float32 sum in shared memory (rounded
//    to nearest) after every tile and zeroed: the tensor cores'
//    truncating adds run over one tile's 128 pixels.
//  * T3's splits: each split is a run of consecutive 2 x 64 tiles, sized
//    from the shapes alone (kernels/train.py wgrad_splits) so that a split's
//    blocks number about 132, one an SM: 43 splits at 64 -> 64, 11 at 128
//    -> 128.  The partials, (9 Cin + 1) x Cout float32 a split, are
//    written once and read once by the split-order sum: 6.4 MB each way
//    at both widths, about 3.8 us at the card's bandwidth (the CUDA-core
//    form's 106 splits moved 15.7 MB each way at 64 -> 64).
//
// The weights' addresses.  Written with __ldg, load_w came out of nvcc
// (sm_90a) with the address of row k0 + 8 kc computed afresh each unit
// but those of rows k0 + 8 kc + 1 .. + 7 from a loop-carried flag for the
// 32 (q & 1) term of Fwd::unit_k0: a uniform predicate (UP0) set false
// before the loop and toggled at its head, so one unit out of phase.  At
// Cin 128, where that term is all that tells a tap's two units apart,
// those seven rows of each 8 came from the other unit of the pair (T1
// 0.88 of max |ref| off its plain version at 128 -> 128); at Cin 64,
// where k0 = 32 q, the result was right.  The
// form in load_w compiles to one row index a unit with the eight loads
// at fixed offsets from it.  Both forms load through LDG.E.CONSTANT, the
// non-coherent path: the path was not the fault.  What catches such a
// fault is T1 held to its plain version at 128 -> 128, 128 -> 64 and
// 128 -> 48 on a step's shape with weights that differ unit to unit, as
// chip_smoke.py's train phase and the card tests do.
#include "tc.cuh"

namespace {

using namespace reve::tc;

constexpr int TW = 64;       // tile columns
constexpr int HP = TW + 2;   // halo pixels of a tile row
constexpr int ROW = 128;     // bytes of a staged pixel: 64 bf16 channels

constexpr int align1024(int n) { return (n + 1023) / 1024 * 1024; }

// out[i] = the sum over p < parts of part[p][i]: T3's split and T2's
// tile partials summed in an order set by the shapes alone (no float
// atomics), so a training step repeats bit for bit.  G threads share a
// column i, thread g summing the run of parts g * per .. (g + 1) * per -
// 1 in order (per = ceil(parts / G)), and the G runs' sums are added in
// g order: G 1 for T3's thousands of columns, 8 for T2's 64 or 128,
// whose one-thread columns would each wait on 256 loads in turn.
template <int G>
__global__ void __launch_bounds__(256)
    sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                     int parts, int n) {
  constexpr int COLS = 256 / G;
  __shared__ float red[256];
  const int t = threadIdx.x, i = blockIdx.x * COLS + t % COLS, g = t / COLS;
  const int per = (parts + G - 1) / G, end = min(parts, (g + 1) * per);
  float s = 0.f;
  if (i < n)
    for (int p = g * per; p < end; ++p)
      s = __fadd_rn(s, part[(long long)p * n + i]);
  if constexpr (G == 1) {
    if (i < n) out[i] = s;
  } else {
    red[t] = s;
    __syncthreads();
    if (g == 0 && i < n) {
#pragma unroll
      for (int k = 1; k < G; ++k) s = __fadd_rn(s, red[t + k * COLS]);
      out[i] = s;
    }
  }
}

template <int G>
cudaError_t sum_parts(const float* part, float* out, int parts, int n,
                      cudaStream_t st) {
  constexpr int COLS = 256 / G;
  sum_parts_kernel<G><<<(n + COLS - 1) / COLS, 256, 0, st>>>(part, out,
                                                             parts, n);
  return cudaGetLastError();
}

// Call F<CIN, COUT>::run(args...) for a channel pair the training convs
// take: Cin 3, 64, 128 x Cout 48, 64, 128; cudaErrorInvalidValue for any
// other.
template <template <int, int> class F, class... A>
cudaError_t dispatch(int cin, int cout, A... args) {
#define REVE_PAIR(CI, CO) \
  if (cin == CI && cout == CO) return F<CI, CO>::run(args...);
#define REVE_ROW(CI) REVE_PAIR(CI, 48) REVE_PAIR(CI, 64) REVE_PAIR(CI, 128)
  REVE_ROW(3)
  REVE_ROW(64)
  REVE_ROW(128)
#undef REVE_ROW
#undef REVE_PAIR
  return cudaErrorInvalidValue;
}

// Eight float32 values (two float4) -> their hi, mid and lo planes, 8
// bf16 (16 B) each.
__device__ __forceinline__ void split8(const float4& a, const float4& c,
                                       uint4& h, uint4& m, uint4& l) {
  split2(a.x, a.y, h.x, m.x, l.x);
  split2(a.z, a.w, h.y, m.y, l.y);
  split2(c.x, c.y, h.z, m.z, l.z);
  split2(c.z, c.w, h.w, m.w, l.w);
}

// The three planes' 16-B rows at `off` of planes `plane` bytes apart.
__device__ __forceinline__ void put3(unsigned char* p, int plane,
                                     uint32_t off, const uint4& h,
                                     const uint4& m, const uint4& l) {
  *reinterpret_cast<uint4*>(p + off) = h;
  *reinterpret_cast<uint4*>(p + plane + off) = m;
  *reinterpret_cast<uint4*>(p + 2 * plane + off) = l;
}

// Six wgmmas of one k16 step from the planes' descriptors (mid and lo of
// A `ap` bytes, of B `bp` bytes after hi): hi.hi into `acc`, the five
// smaller products into `cor`, smallest first.
template <int N, class Mma>
__device__ __forceinline__ void mma_bf16x6(float (&acc)[N / 2],
                                           float (&cor)[N / 2], uint32_t a,
                                           uint32_t ap, uint32_t b,
                                           uint32_t bp, Mma mma) {
  mma(cor, a + 2 * ap, b);
  mma(cor, a, b + 2 * bp);
  mma(cor, a + ap, b + bp);
  mma(cor, a + ap, b);
  mma(cor, a, b + bp);
  mma(acc, a, b);
}

// D (64 x 64, float32) += A (64 x 16) * B (16 x 64), bf16 from shared
// memory, both MN-major (wgmma's transpose flags set): each operand a
// stack of 128-B rows, one a k, of 64 M (N) values in the 128-B swizzle,
// 8-row groups 1024 B apart (SBO); one 64-wide swizzle atom, so the
// leading byte offset goes unused.  T3's A (x, rows = pixels, 64 input
// channels) and B (dz, 64 output channels).
__device__ __forceinline__ void wgmma_mn64(float (&d)[32], uint32_t a,
                                           uint32_t b) {
  const uint64_t da = desc_sw128(a), db = desc_sw128(b);
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// T3's wgmma (both operands MN-major), for mma_bf16x6.
struct WgradMma {
  __device__ void operator()(float (&d)[32], uint32_t a, uint32_t b) const {
    wgmma_mn64(d, a, b);
  }
};

__device__ __forceinline__ bool inside(int y, int x, int H, int W) {
  return (unsigned)y < (unsigned)H && (unsigned)x < (unsigned)W;
}

// 8 channels of pixel (b, y, x) of a (B, H, W, C) float32 tensor from
// channel c, or zeros outside the image.
template <int C>
__device__ __forceinline__ void load8(const float* __restrict__ t, int b,
                                      int y, int x, int c, int H, int W,
                                      bool ok, float4 (&v)[2]) {
  v[0] = v[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ok && inside(y, x, H, W)) {
    const float4* s = reinterpret_cast<const float4*>(
        t + (((long long)b * H + y) * W + x) * C + c);
    v[0] = s[0];
    v[1] = s[1];
  }
}

// The 8 im2col values k = 8 kc .. 8 kc + 7 (k = 3 tap + c, tap = 3 dy +
// dx; zero from k = 27) of output pixel (b, y, x) of a 3-channel input.
__device__ __forceinline__ void load_rgb8(const float* __restrict__ x, int b,
                                          int y, int xx, int kc, int H,
                                          int W, bool ok, float4 (&v)[2]) {
  float f[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int k = 8 * kc + e, tap = k / 3, c = k - 3 * tap;
    const int yy = y + tap / 3 - 1, xc = xx + tap % 3 - 1;
    f[e] = ok && k < 27 && inside(yy, xc, H, W)
               ? x[(((long long)b * H + yy) * W + xc) * 3 + c]
               : 0.f;
  }
  v[0] = make_float4(f[0], f[1], f[2], f[3]);
  v[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// ---------------------------------------------------------------------------
// T1

template <int CIN, int COUT>
struct Fwd {
  static constexpr int NB = COUT == 48 ? 48 : 64;  // N of a block
  static constexpr int NBLK = COUT / NB;
  static constexpr int TH = 2;                    // rows: one a warpgroup
  static constexpr int THREADS = 128 * TH;
  static constexpr bool RGB = CIN == 3;
  static constexpr int HALVES = RGB ? 1 : CIN / 64;
  // units of K: a tap's 32 input channels (Cin 3: its 27 values in 32)
  static constexpr int UPH = RGB ? 1 : 18;  // units a half
  static constexpr int UNITS = HALVES * UPH;
  // A: the halo's 4 x 66 pixel rows, or Cin 3's im2col [row][k / 8][64][8]
  static constexpr int A_PLANE =
      RGB ? TH * 4 * TW * 16 : align1024((TH + 2) * HP * ROW);
  static constexpr int W_PLANE = 32 * NB * 2;           // a unit's [4][NB][8]
  static constexpr int OFF_W = 3 * A_PLANE;
  static constexpr int SMEM = OFF_W + 3 * W_PLANE;
  static_assert(2 * (SMEM + 1024) <= 233472, "two blocks an SM");
  static_assert(4 * NB <= THREADS, "a unit's weights: one task a thread");

  // The first weight row of unit u: half u / UPH, tap (u % UPH) / 2, 32
  // channels (u % 2).
  __device__ static int unit_k0(int u) {
    if (RGB) return 0;
    const int h = u / UPH, q = u - h * UPH;
    return (q >> 1) * CIN + 64 * h + 32 * (q & 1);
  }
};

// The wgmma of T1's k16 step: A the halo (K-major, 128-B swizzle) or
// Cin 3's im2col (K-major, no swizzle, k blocks 1024 B apart), B the
// weights (K-major, no swizzle, k blocks N * 16 B apart).
template <int N, bool RGB>
struct FwdMma {
  __device__ void operator()(float (&d)[N / 2], uint32_t a,
                             uint32_t b) const {
    Wgmma<N>::mma(d, RGB ? desc(a, 1024) : desc_sw128(a), desc(b, N * 16));
  }
};

// This thread's column of a unit's weights: k = k0 + 8 kc .. + 7 of
// column n0 + n, (kc, n) = (t / NB, t % NB); rows from `valid` on zero.
// Indexed as written here, not through __ldg: see "The weights'
// addresses" in the head note.
template <int COUT, int NB>
__device__ __forceinline__ void load_w(const float* __restrict__ w, int k0,
                                       int valid, int n0, int t,
                                       float4 (&v)[2]) {
  const int kc = t / NB, n = t - kc * NB;
  float f[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int k = 8 * kc + e;
    f[e] = kc < 4 && k < valid ? w[(long long)(k0 + k) * COUT + n0 + n] : 0.f;
  }
  v[0] = make_float4(f[0], f[1], f[2], f[3]);
  v[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// The halo of a (B, H, W, CH) tensor (T1's x, T2's dz) for half h of the
// tile at (b, y0, x0): halo pixel hp (row hp / 66 from y0 - 1, column hp
// % 66 from x0 - 1), channels 8 j .. 8 j + 7 of the half at 16-B chunk j
// of its 128-B row, in the 128-B swizzle; zeros from channel CH on (CH
// 48).  In batches of 2 tasks: their loads in flight together.
template <class C, int CH>
__device__ __forceinline__ void stage_halo(unsigned char* a,
                                           const float* __restrict__ x,
                                           int b, int y0, int x0, int h,
                                           int H, int W, int t) {
  constexpr int BATCH = 2;
  constexpr int TASKS = (C::TH + 2) * HP * 8;  // (halo pixel, 8 channels)
  constexpr int N = (TASKS + C::THREADS - 1) / C::THREADS;
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += BATCH) {
    float4 v[BATCH][2];
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      const int i = t + C::THREADS * (n0 + q), hp = i >> 3, j = i & 7;
      const int r = hp / HP, c = hp - r * HP;
      load8<CH>(x, b, y0 - 1 + r, x0 - 1 + c, 64 * h + 8 * j, H, W,
                n0 + q < N && i < TASKS && 64 * h + 8 * j < CH, v[q]);
    }
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      const int i = t + C::THREADS * (n0 + q);
      if (n0 + q < N && i < TASKS) {
        uint4 hi, mi, lo;
        split8(v[q][0], v[q][1], hi, mi, lo);
        put3(a, C::A_PLANE, swizzle<128>((i >> 3) * ROW + (i & 7) * 16), hi,
             mi, lo);
      }
    }
  }
}

// Cin 3: the tile's im2col, pixel (row r, column m) and k / 8 = kc at
// [r][kc][m][8] of each plane (K-major, no swizzle).
template <class C>
__device__ __forceinline__ void stage_rgb(unsigned char* a,
                                          const float* __restrict__ x, int b,
                                          int y0, int x0, int H, int W,
                                          int t) {
  constexpr int N = C::TH * TW * 4 / C::THREADS;  // (pixel, k / 8) tasks
  float4 v[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int i = t + C::THREADS * n, m = i & 63, kc = (i >> 6) & 3,
              r = i >> 8;
    load_rgb8(x, b, y0 + r, x0 + m, kc, H, W, true, v[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int i = t + C::THREADS * n;
    uint4 hi, mi, lo;
    split8(v[n][0], v[n][1], hi, mi, lo);
    put3(a, C::A_PLANE, (i >> 8) * 4096 + (((i >> 6) & 3) * 64 + (i & 63)) * 16,
         hi, mi, lo);
  }
}

// T1: blockIdx.x the tile (2 rows x 64 pixels, x fastest), blockIdx.y the
// N block.  alpha == nullptr: the head, y = z; else y = PReLU(z) and z is
// written too when z != nullptr.
template <int CIN, int COUT>
__global__ void __launch_bounds__(Fwd<CIN, COUT>::THREADS, 2)
    fwd_tc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias,
                  const float* __restrict__ alpha, float* __restrict__ y,
                  float* __restrict__ z, int H, int W) {
  using C = Fwd<CIN, COUT>;
  constexpr int NB = C::NB;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int t = threadIdx.x, wg = t >> 7;
  const int tx = (W + TW - 1) / TW, ty = (H + C::TH - 1) / C::TH;
  const int b = blockIdx.x / (tx * ty), rem = blockIdx.x - b * tx * ty;
  const int y0 = rem / tx * C::TH, x0 = rem % tx * TW;
  const int n0 = blockIdx.y * NB;

  float acc[NB / 2], cor[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = cor[i] = 0.f;
  constexpr int VALID = C::RGB ? 27 : 32;
  float4 wv[2];
  load_w<COUT, NB>(w, C::unit_k0(0), VALID, n0, t, wv);
#pragma unroll 1
  for (int u = 0; u < C::UNITS; ++u) {
    if (u % C::UPH == 0) {
      if constexpr (C::RGB)
        stage_rgb<C>(smem, x, b, y0, x0, H, W, t);
      else
        stage_halo<C, CIN>(smem, x, b, y0, x0, u / C::UPH, H, W, t);
    }
    if (t < 4 * NB) {
      uint4 hi, mi, lo;
      split8(wv[0], wv[1], hi, mi, lo);
      const int kc = t / NB;
      put3(smem + C::OFF_W, C::W_PLANE, (kc * NB + t - kc * NB) * 16, hi, mi,
           lo);
    }
    // the next unit's weights load while this unit's wgmmas run
    if (u + 1 < C::UNITS)
      load_w<COUT, NB>(w, C::unit_k0(u + 1), VALID, n0, t, wv);
    fence_proxy_async();
    __syncthreads();
    const int q = u % C::UPH;
    const uint32_t a =
        C::RGB ? base + wg * 4096
               : base + ((wg + (q >> 1) / 3) * HP + (q >> 1) % 3) * ROW +
                     32 * 2 * (q & 1);
    const uint32_t wb = base + C::OFF_W;
    fence_regs(acc);
    fence_regs(cor);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s)
      // step s: k blocks 2s, 2s + 1 (A: 32 B on in the swizzled rows, or
      // 2048 B on in the im2col; B: 2 NB * 16 B on)
      mma_bf16x6<NB>(acc, cor, a + (C::RGB ? 2048 : 32) * s, C::A_PLANE,
                     wb + 2 * s * NB * 16, C::W_PLANE, FwdMma<NB, C::RGB>());
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(cor);
    __syncthreads();  // every warpgroup is done with the unit's planes
  }

  // accumulator fragment: register 4j + 2h + e holds pixel 16 * warp +
  // lane / 4 + 8h of this warpgroup's row, channel 8j + 2 (lane % 4) + e
  const int oy = y0 + wg;
  if (oy >= H) return;
  const int lane = t & 31;
  const int p0 = ((t >> 5) & 3) * 16 + (lane >> 2), c0 = (lane & 3) * 2;
  const long long row = ((long long)(blockIdx.x / (tx * ty)) * H + oy) * W;
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    const int c = n0 + 8 * j + c0;
    const float2 bv = *reinterpret_cast<const float2*>(bias + c);
    float2 av = make_float2(0.f, 0.f);
    if (alpha) av = *reinterpret_cast<const float2*>(alpha + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = x0 + p0 + 8 * h;
      if (px >= W) continue;
      const int r = 4 * j + 2 * h;
      // conv + b in float32; PReLU: max(z, 0) + alpha * min(z, 0)
      const float z0 = __fadd_rn(__fadd_rn(acc[r], cor[r]), bv.x);
      const float z1 = __fadd_rn(__fadd_rn(acc[r + 1], cor[r + 1]), bv.y);
      const long long o = (row + px) * COUT + c;
      if (!alpha) {
        *reinterpret_cast<float2*>(y + o) = make_float2(z0, z1);
        continue;
      }
      *reinterpret_cast<float2*>(y + o) =
          make_float2(z0 > 0.f ? z0 : __fmul_rn(av.x, z0),
                      z1 > 0.f ? z1 : __fmul_rn(av.y, z1));
      if (z) *reinterpret_cast<float2*>(z + o) = make_float2(z0, z1);
    }
  }
}

// ---------------------------------------------------------------------------
// T2

template <int CIN, int COUT>
struct Dgrad {
  static constexpr int NB = CIN == 3 ? 8 : 64;     // N of a block
  static constexpr int NBLK = CIN == 128 ? 2 : 1;
  static constexpr int TH = 2;                     // rows: one a warpgroup
  static constexpr int THREADS = 128 * TH;
  static constexpr int HALVES = (COUT + 63) / 64;  // of Cout (48: one)
  // units of K: a tap's 32 output channels
  static constexpr int UPH = 18;                   // units a half
  static constexpr int UNITS = HALVES * UPH;
  // A: dz's halo, 4 x 66 pixel rows of a half
  static constexpr int A_PLANE = align1024((TH + 2) * HP * ROW);
  static constexpr int W_PLANE = 32 * NB * 2;      // a unit's [4][NB][8]
  static constexpr int OFF_W = 3 * A_PLANE;
  static constexpr int SMEM = OFF_W + 3 * W_PLANE;
  static_assert(2 * (SMEM + 1024) <= 233472, "two blocks an SM");
  static_assert(4 * NB <= THREADS, "a unit's weights: one task a thread");
  static_assert(8 * NB * 4 <= A_PLANE, "d(alpha)'s warp sums fit A");
};

// This thread's task of unit u's weights: column n = n0 + (t % 8) + 8 (t /
// 32) (a ci), k = 8 kc .. 8 kc + 7 with kc = (t / 8) % 4, i.e. output
// channels co = 64 (u / 18) + 32 (u % 2) + 8 kc .. + 7 of tap (u % 18) /
// 2: W[tap][n][co .. co + 7], 32 consecutive bytes, zeros past Cin or
// Cout.  A warp reads 8 columns' whole 128-B runs; 8 threads of one kc
// store 8 consecutive 16-B rows (no bank conflict).  One row index a
// unit, the two loads at fixed offsets from it (see "The weights'
// addresses" in the head note).  No branch: it runs between T2's wgmmas
// and their wait, where a branch on the thread would serialise them; a
// task with no weights (Cin 3's columns 3-7, Cout 48's channels 48-63)
// loads w's first 32 B and keeps zeros.
template <class C, int CIN, int COUT>
__device__ __forceinline__ void load_wt(const float* __restrict__ w, int u,
                                        int n0, int t, float4 (&v)[2]) {
  const int kc = (t >> 3) & 3, n = n0 + (t & 7) + 8 * (t >> 5);
  const int h = u / C::UPH, q = u - h * C::UPH;
  const int co = 64 * h + 32 * (q & 1) + 8 * kc;
  const bool ok = (4 * C::NB == C::THREADS || t < 4 * C::NB) &&
                  (COUT % 64 == 0 || co < COUT) && (CIN % 64 == 0 || n < CIN);
  const float4* s = reinterpret_cast<const float4*>(
      ok ? w + (long long)((q >> 1) * CIN + n) * COUT + co : w);
  const float4 a = s[0], c = s[1], z = make_float4(0.f, 0.f, 0.f, 0.f);
  v[0] = ok ? a : z;
  v[1] = ok ? c : z;
}

// JAX's PReLU vjp: dz = dy * s(z > 0) + (alpha dy) * s(z < 0), where s
// is 1, 0 or, at a tie z = 0, 0.5 (lax.max / lax.min's balanced
// gradient).
__device__ __forceinline__ float prelu_grad(float dy, float z, float a) {
  if (z > 0.f) return dy;
  if (z < 0.f) return a * dy;
  return dy * 0.5f + (a * dy) * 0.5f;
}

// T2 for a layer CIN -> COUT: blockIdx.x the tile (2 rows x 64 pixels, x
// fastest), blockIdx.y the N block.  Reads dz (COUT channels), writes the
// previous layer's dz (CIN channels) and the tile's d(alpha) partial row
// part[blockIdx.x][n0 ..].
template <int CIN, int COUT>
__global__ void __launch_bounds__(Dgrad<CIN, COUT>::THREADS, 2)
    dgrad_tc_kernel(const float* __restrict__ dz, const float* __restrict__ w,
                    const float* __restrict__ zprev,
                    const float* __restrict__ alpha,
                    float* __restrict__ dzprev, float* __restrict__ part,
                    int H, int W) {
  using C = Dgrad<CIN, COUT>;
  constexpr int NB = C::NB;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int t = threadIdx.x, wg = t >> 7;
  const int tx = (W + TW - 1) / TW, ty = (H + C::TH - 1) / C::TH;
  const int b = blockIdx.x / (tx * ty), rem = blockIdx.x - b * tx * ty;
  const int y0 = rem / tx * C::TH, x0 = rem % tx * TW;
  const int n0 = blockIdx.y * NB;

  float acc[NB / 2], cor[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = cor[i] = 0.f;
  float4 wv[2];
  load_wt<C, CIN, COUT>(w, 0, n0, t, wv);
#pragma unroll 1
  for (int u = 0; u < C::UNITS; ++u) {
    if (u % C::UPH == 0)
      stage_halo<C, COUT>(smem, dz, b, y0, x0, u / C::UPH, H, W, t);
    if (t < 4 * NB) {
      uint4 hi, mi, lo;
      split8(wv[0], wv[1], hi, mi, lo);
      put3(smem + C::OFF_W, C::W_PLANE,
           (((t >> 3) & 3) * NB + (t & 7) + 8 * (t >> 5)) * 16, hi, mi, lo);
    }
    fence_proxy_async();
    __syncthreads();
    // tap (ky, kx) = ((q / 2) / 3, (q / 2) % 3), mirrored: row wg of the
    // output reads halo row wg + 2 - ky, pixel m halo column m + 2 - kx
    const int q = u % C::UPH, tap = q >> 1;
    const uint32_t a = base + ((wg + 2 - tap / 3) * HP + 2 - tap % 3) * ROW +
                       32 * 2 * (q & 1);
    const uint32_t wb = base + C::OFF_W;
    fence_regs(acc);
    fence_regs(cor);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s)
      // step s: k blocks 2s, 2s + 1 (A: 32 B on in the swizzled rows; B:
      // 2 NB * 16 B on)
      mma_bf16x6<NB>(acc, cor, a + 32 * s, C::A_PLANE, wb + 2 * s * NB * 16,
                     C::W_PLANE, FwdMma<NB, false>());
    wgmma_commit();
    // the next unit's weights load while this unit's wgmmas run: issued
    // after the proxy fence above, which waits for a thread's loads in
    // flight (the last unit loads its own again)
    load_wt<C, CIN, COUT>(w, u + 1 < C::UNITS ? u + 1 : u, n0, t, wv);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(cor);
    __syncthreads();  // every warpgroup is done with the unit's planes
  }

  // accumulator fragment: register 4j + 2h + e holds pixel 16 * warp +
  // lane / 4 + 8h of this warpgroup's row, channel 8j + 2 (lane % 4) + e
  const int oy = y0 + wg, lane = t & 31, warp = t >> 5;
  const int p0 = (warp & 3) * 16 + (lane >> 2), c0 = (lane & 3) * 2;
  const long long row = ((long long)b * H + oy) * W;
  // d(alpha) of this thread's columns 8j + c0 + e, at 2j + e
  float da[NB / 4];
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    const int c = n0 + 8 * j + c0;
    da[2 * j] = da[2 * j + 1] = 0.f;
    float av[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (c + e < CIN) av[e] = alpha[c + e];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = x0 + p0 + 8 * h;
      if (oy >= H || px >= W) continue;
      const int r = 4 * j + 2 * h;
      const float d[2] = {__fadd_rn(acc[r], cor[r]),
                          __fadd_rn(acc[r + 1], cor[r + 1])};
      const long long o = (row + px) * CIN + c;
      float zv[2] = {0.f, 0.f}, g[2];
      if constexpr (CIN % 8 == 0) {
        const float2 z2 = *reinterpret_cast<const float2*>(zprev + o);
        zv[0] = z2.x;
        zv[1] = z2.y;
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c + e < CIN) zv[e] = zprev[o + e];
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        g[e] = prelu_grad(d[e], zv[e], av[e]);
        da[2 * j + e] = fmaf(d[e], fminf(zv[e], 0.f), da[2 * j + e]);
      }
      if constexpr (CIN % 8 == 0) {
        *reinterpret_cast<float2*>(dzprev + o) = make_float2(g[0], g[1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c + e < CIN) dzprev[o + e] = g[e];
      }
    }
  }
  // the block's d(alpha) partial row: each column over the 8 lanes that
  // hold it (lane / 4), then over the 8 warps in order; A's planes are
  // free after the mainloop's last barrier
#pragma unroll
  for (int i = 0; i < NB / 4; ++i)
#pragma unroll
    for (int m = 4; m < 32; m <<= 1)
      da[i] = __fadd_rn(da[i], __shfl_xor_sync(0xFFFFFFFFu, da[i], m));
  float* red = reinterpret_cast<float*>(smem);
  if (lane < 4)
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      red[warp * NB + 8 * j + c0] = da[2 * j];
      red[warp * NB + 8 * j + c0 + 1] = da[2 * j + 1];
    }
  __syncthreads();
  if (t < NB && n0 + t < CIN) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s = __fadd_rn(s, red[i * NB + t]);
    part[(long long)blockIdx.x * CIN + n0 + t] = s;
  }
}

// ---------------------------------------------------------------------------
// T3

template <int CIN, int COUT>
struct Wgrad {
  static constexpr bool RGB = CIN == 3;
  // warpgroups that run wgmmas, one a tap dx (Cin 3: one slab), and in
  // all (Cin 3: a second that only stages)
  static constexpr int MWG = RGB ? 1 : 3;
  static constexpr int THREADS = 128 * (RGB ? 2 : 3);
  static constexpr int TH = 2;             // rows of a tile (K chunk)
  static constexpr int HALVES = RGB ? 1 : CIN / 64;
  static constexpr int NBLK = COUT == 128 ? 2 : 1;  // N blocks of 64
  static constexpr int GROUPS = (RGB ? 1 : 3 * HALVES) * NBLK;
  static constexpr int ROWS = 9 * CIN + 1;  // dW, then db
  // x: 2 rows x 66 halo pixels of a half, or Cin 3's 2 x 64 im2col rows
  static constexpr int X_PX = RGB ? TH * TW : TH * HP;
  static constexpr int X_PLANE = align1024(X_PX * ROW);
  static constexpr int D_PLANE = TH * TW * ROW;
  static constexpr int OFF_D = 3 * X_PLANE;
  // the running float32 sums of hi.hi, one 64 x 64 slab a warpgroup
  static constexpr int OFF_TOT = OFF_D + 3 * D_PLANE;
  static constexpr int SMEM = OFF_TOT + MWG * 64 * 64 * 4;
  static constexpr int XT = RGB ? TH * TW * 4 : X_PX * 8;  // x tasks
  static constexpr int DT = TH * TW * 8;                   // dz tasks
  static constexpr int NX = (XT + THREADS - 1) / THREADS;
  static constexpr int ND = (DT + THREADS - 1) / THREADS;
  static_assert(THREADS % 8 == 0, "a thread stages fixed 8 channels");
  static_assert(THREADS * 8 * 4 <= OFF_TOT, "db's sums fit the planes");
  static_assert(!RGB || 2 * (SMEM + 1024) <= 233472, "two blocks an SM");
};

// One tile's operands in flight: this thread's x and dz tasks as float32.
template <class C>
struct Raw {
  float4 x[C::NX][2];
  float4 d[C::ND][2];
};

// The loads of tile `tile` (2 x 64 pixels, x fastest): x task i = (pixel
// i / 8 of the 2 x 66 halo, whose rows are the tile's shifted by dy,
// channels 8 (i % 8) of half h), or Cin 3's (pixel i % 64 of row i / 256,
// k / 8 = (i / 64) % 4); dz task i = (pixel i / 8, channels n0 + 8 (i %
// 8)), zeros past Cout.
template <class C, int CIN, int COUT>
__device__ __forceinline__ void load_tile(Raw<C>& raw,
                                          const float* __restrict__ x,
                                          const float* __restrict__ dz,
                                          int tile, int tx, int ty, int dy,
                                          int h, int n0, int H, int W,
                                          int t) {
  const int b = tile / (tx * ty), rem = tile - b * tx * ty;
  const int y0 = rem / tx * C::TH, x0 = rem % tx * TW;
#pragma unroll
  for (int n = 0; n < C::NX; ++n) {
    const int i = t + C::THREADS * n;
    if constexpr (C::RGB) {
      load_rgb8(x, b, y0 + (i >> 8), x0 + (i & 63), (i >> 6) & 3, H, W,
                i < C::XT, raw.x[n]);
    } else {
      const int hp = i >> 3, r = hp / HP, c = hp - r * HP;
      load8<CIN>(x, b, y0 + r + dy, x0 - 1 + c, 64 * h + 8 * (i & 7), H, W,
                 i < C::XT, raw.x[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < C::ND; ++n) {
    const int i = t + C::THREADS * n, p = i >> 3, ch = n0 + 8 * (i & 7);
    load8<COUT>(dz, b, y0 + (p >> 6), x0 + (p & 63), ch, H, W,
                i < C::DT && ch < COUT, raw.d[n]);
  }
}

// ... their planes, in the 128-B swizzle; with DB, each dz value also
// into this thread's sums of its 8 channels.
template <class C, bool DB>
__device__ __forceinline__ void stage_tile(unsigned char* smem,
                                           const Raw<C>& raw, int t,
                                           float (&dbs)[8]) {
#pragma unroll
  for (int n = 0; n < C::NX; ++n) {
    const int i = t + C::THREADS * n;
    if (i >= C::XT) continue;
    uint4 hi, mi, lo;
    split8(raw.x[n][0], raw.x[n][1], hi, mi, lo);
    const int row = C::RGB ? (i >> 8) * TW + (i & 63) : i >> 3;
    const int chunk = C::RGB ? (i >> 6) & 3 : i & 7;
    put3(smem, C::X_PLANE, swizzle<128>(row * ROW + chunk * 16), hi, mi, lo);
  }
#pragma unroll
  for (int n = 0; n < C::ND; ++n) {
    const int i = t + C::THREADS * n;
    if (i >= C::DT) continue;
    uint4 hi, mi, lo;
    split8(raw.d[n][0], raw.d[n][1], hi, mi, lo);
    put3(smem + C::OFF_D, C::D_PLANE, swizzle<128>((i >> 3) * ROW + (i & 7) * 16),
         hi, mi, lo);
    if constexpr (DB) {
      const float f[8] = {raw.d[n][0].x, raw.d[n][0].y, raw.d[n][0].z,
                          raw.d[n][0].w, raw.d[n][1].x, raw.d[n][1].y,
                          raw.d[n][1].z, raw.d[n][1].w};
#pragma unroll
      for (int e = 0; e < 8; ++e) dbs[e] = __fadd_rn(dbs[e], f[e]);
    }
  }
}

// T3: blockIdx.x the split (tiles [split * per, (split + 1) * per)),
// blockIdx.y the group: N block n0 / 64, and (Cin 64, 128) the half and
// the tap row dy, warpgroup w the tap dx = w - 1 (Cin 3: warpgroup 0 the
// slab, warpgroup 1 stages only).  Writes the split's partial rows of
// [dW; db] (9 CIN + 1 rows of COUT).  hi.hi's accumulators are added into
// a float32 sum in shared memory after every tile (rounded to nearest)
// and zeroed: the tensor cores' truncating adds run over one tile's 128
// pixels, not the split's.
template <int CIN, int COUT>
__global__ void __launch_bounds__(Wgrad<CIN, COUT>::THREADS, 1)
    wgrad_tc_kernel(const float* __restrict__ x, const float* __restrict__ dz,
                    float* __restrict__ part, int B, int H, int W, int per) {
  using C = Wgrad<CIN, COUT>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int t = threadIdx.x, wg = t >> 7;
  const int nb = blockIdx.y % C::NBLK, rest = blockIdx.y / C::NBLK;
  const int h = rest % C::HALVES, dyi = rest / C::HALVES;
  const int n0 = 64 * nb;
  const bool has_db = C::RGB || (dyi == 1 && h == 0);
  const int tx = (W + TW - 1) / TW, ty = (H + C::TH - 1) / C::TH;
  const int tiles = B * tx * ty;
  const int first = blockIdx.x * per, last = min(first + per, tiles);

  // the hi.hi sums start at zero (Cin 3: so do A's rows 27-63, which the
  // wgmmas read but nothing stages)
  float* tot = reinterpret_cast<float*>(smem + C::OFF_TOT) + wg * 64 * 64;
  for (int i = t; i < C::MWG * 64 * 64 / 4; i += C::THREADS)
    reinterpret_cast<float4*>(smem + C::OFF_TOT)[i] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (C::RGB)
    for (int i = t; i < 3 * C::X_PLANE / 16; i += C::THREADS)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const bool mma = wg < C::MWG;
  float acc[32], cor[32], dbs[8];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = cor[i] = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) dbs[e] = 0.f;

  Raw<C> raw;
  load_tile<C, CIN, COUT>(raw, x, dz, first, tx, ty, dyi - 1, h, n0, H, W, t);
  // the A rows of warpgroup wg's tap: halo column c + dx + 1 for pixel c
  const uint32_t xa = base + (C::RGB ? 0 : wg * ROW);
  const uint32_t da = base + C::OFF_D;
#pragma unroll 1
  for (int tile = first; tile < last; ++tile) {
    if (has_db)
      stage_tile<C, true>(smem, raw, t, dbs);
    else
      stage_tile<C, false>(smem, raw, t, dbs);
    // the next tile's loads are in flight while this one's wgmmas run
    if (tile + 1 < last)
      load_tile<C, CIN, COUT>(raw, x, dz, tile + 1, tx, ty, dyi - 1, h, n0,
                              H, W, t);
    fence_proxy_async();
    __syncthreads();
    if (mma) {
      fence_regs(acc);
      fence_regs(cor);
      wgmma_fence();
#pragma unroll
      for (int r = 0; r < C::TH; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          mma_bf16x6<64>(
              acc, cor, xa + ((C::RGB ? r * TW : r * HP) + 16 * s) * ROW,
              C::X_PLANE, da + (r * TW + 16 * s) * ROW, C::D_PLANE,
              WgradMma());
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(cor);
      // this thread's 32 sums, register i at tot[i][t]: a warp's 32
      // consecutive words
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float* p = tot + i * 128 + (t & 127);
        *p = __fadd_rn(*p, acc[i]);
        acc[i] = 0.f;
      }
    }
    __syncthreads();  // every warpgroup is done with the tile's planes
  }

  // accumulator fragment: register 4j + 2h + e holds row 16 * warp + lane
  // / 4 + 8h of the slab (an input channel, or Cin 3's 3 tap + c),
  // column 8j + 2 (lane % 4) + e of the N block
  float* out = part + (long long)blockIdx.x * C::ROWS * COUT;
  const int lane = t & 31;
  const int m0 = ((t >> 5) & 3) * 16 + (lane >> 2), c0 = (lane & 3) * 2;
  const int tap = 3 * dyi + wg;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = n0 + 8 * j + c0;
    if (!mma || c >= COUT) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + 8 * hh;
      if (C::RGB && m >= 27) continue;
      const int row = C::RGB ? m : tap * CIN + 64 * h + m;
      const int r = 4 * j + 2 * hh;
      *reinterpret_cast<float2*>(out + (long long)row * COUT + c) =
          make_float2(__fadd_rn(tot[r * 128 + (t & 127)], cor[r]),
                      __fadd_rn(tot[(r + 1) * 128 + (t & 127)], cor[r + 1]));
    }
  }
  if (!has_db) return;
  // db: the threads' sums of their 8 channels (t % 8), added in thread
  // order
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int e = 0; e < 8; ++e) red[t * 8 + e] = dbs[e];
  __syncthreads();
  if (t < 64 && n0 + t < COUT) {
    const int j = t >> 3, e = t & 7;
    float s = 0.f;
    for (int u = j; u < C::THREADS; u += 8) s = __fadd_rn(s, red[u * 8 + e]);
    out[(long long)(9 * CIN) * COUT + n0 + t] = s;
  }
}

template <int CIN, int COUT>
struct FwdLaunch {
  static cudaError_t run(const float* x, const float* w, const float* b,
                         const float* alpha, float* y, float* z, int B, int H,
                         int W, cudaStream_t st) {
    using C = Fwd<CIN, COUT>;
    auto kernel = fwd_tc_kernel<CIN, COUT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    const long long tiles =
        (long long)B * ((H + C::TH - 1) / C::TH) * ((W + TW - 1) / TW);
    if (tiles > 0x7FFFFFFF) return cudaErrorInvalidValue;
    dim3 grid((unsigned)tiles, C::NBLK);
    kernel<<<grid, C::THREADS, C::SMEM, st>>>(x, w, b, alpha, y, z, H, W);
    return cudaGetLastError();
  }
};

template <int CIN, int COUT>
struct DgradLaunch {
  static cudaError_t run(const float* dz, const float* w, const float* zprev,
                         const float* alpha, float* dzprev, float* part,
                         float* dalpha, int B, int H, int W,
                         cudaStream_t st) {
    using C = Dgrad<CIN, COUT>;
    auto kernel = dgrad_tc_kernel<CIN, COUT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    const long long tiles =
        (long long)B * ((H + C::TH - 1) / C::TH) * ((W + TW - 1) / TW);
    if (tiles > 0x7FFFFFFF) return cudaErrorInvalidValue;
    dim3 grid((unsigned)tiles, C::NBLK);
    kernel<<<grid, C::THREADS, C::SMEM, st>>>(dz, w, zprev, alpha, dzprev,
                                              part, H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return sum_parts<8>(part, dalpha, (int)tiles, CIN, st);
  }
};

template <int CIN, int COUT>
struct WgradLaunch {
  static cudaError_t run(const float* x, const float* dz, float* part,
                         float* dwb, int B, int H, int W, int splits, int per,
                         cudaStream_t st) {
    using C = Wgrad<CIN, COUT>;
    const long long tiles =
        (long long)B * ((H + C::TH - 1) / C::TH) * ((W + TW - 1) / TW);
    // the splits cover the tiles, none of them empty
    if (per < 1 || (long long)(splits - 1) * per >= tiles ||
        (long long)splits * per < tiles)
      return cudaErrorInvalidValue;
    auto kernel = wgrad_tc_kernel<CIN, COUT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    dim3 grid(splits, C::GROUPS);
    kernel<<<grid, C::THREADS, C::SMEM, st>>>(x, dz, part, B, H, W, per);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return sum_parts<1>(part, dwb, splits, C::ROWS * COUT, st);
  }
};

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a channel pair it does not take).  The
// wrapper (reve_tpu_torch/kernels/train.py) allocates every output and
// scratch buffer.

// T1 over (B, H, W, cin) float32 x and (3, 3, cin, cout) float32 w.
extern "C" int reve_conv3x3_fwd_train_tc(const float* x, const float* w,
                                         const float* b, const float* alpha,
                                         float* y, float* z, int B, int H,
                                         int W, int cin, int cout,
                                         void* stream) {
  if ((long long)B * H * W == 0) return (int)cudaSuccess;
  return (int)dispatch<FwdLaunch>(cin, cout, x, w, b, alpha, y, z, B, H, W,
                                  static_cast<cudaStream_t>(stream));
}

// T2 over (B, H, W, cout) float32 dz, (3, 3, cin, cout) w and (B, H, W,
// cin) z_prev: dz_prev, and d(alpha) as the sum in tile order of the
// tiles' partial rows, (tiles, cin) in `part`.
extern "C" int reve_conv3x3_dgrad_tc(const float* dz, const float* w,
                                     const float* zprev, const float* alpha,
                                     float* dzprev, float* part,
                                     float* dalpha, int B, int H, int W,
                                     int cin, int cout, void* stream) {
  if ((long long)B * H * W == 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch<DgradLaunch>(cin, cout, dz, w, zprev, alpha, dzprev,
                                    part, dalpha, B, H, W,
                                    static_cast<cudaStream_t>(stream));
}

// T3: `splits` splits of `per` consecutive 2 x 64 tiles, each writing
// its (9 cin + 1) x cout rows of [dW; db] into `part`, then their sum in
// split order into `dwb`.
extern "C" int reve_conv3x3_wgrad_tc(const float* x, const float* dz,
                                     float* part, float* dwb, int B, int H,
                                     int W, int cin, int cout, int splits,
                                     int per, void* stream) {
  if ((long long)B * H * W == 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch<WgradLaunch>(cin, cout, x, dz, part, dwb, B, H, W,
                                    splits, per,
                                    static_cast<cudaStream_t>(stream));
}
