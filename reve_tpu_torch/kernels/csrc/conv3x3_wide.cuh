// K1 conv3x3_bias_prelu and K2 head_conv_residual_u8_shuffle of an SRVGG
// of 32, 96 or 128 features, in both compute dtypes, on the tensor cores:
// two templates, instantiated by conv3x3_tc.cu in bfloat16 (PLANES 1) and
// by conv3x3_f32_tc.cu in float32 (PLANES 3, the split planes, six bf16
// products).  The 64-feature forms are those sources' own kernels,
// unchanged.
//
// Replaces (TPU side) what those sources' kernels replace, at the SRVGG's
// num_feat F: reve_tpu/models/srvgg.py:_conv3x3 + _prelu (srvgg.py:88-113)
// over F -> F, apply's hidden layers (srvgg.py:205-210), and the head
// _conv3x3 F -> 3r^2 (srvgg.py:211-212) with _epilogue(quantize_u8=True)
// (srvgg.py:239-262) and reve_tpu/ops/pixel_shuffle.py:14-22.  What they
// compute and where they round is the 64-feature kernels' (K1: + b in
// float32, cast to bf16, PReLU in bf16; float32: + b and PReLU in
// float32; K2: tc.cuh's HeadEpilogue).
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) per call of 4 1080p
// frames (P = 8.29 M pixels): bf16 K1 at F = 32 2 P F 2 B in + out ->
// 0.317 ms (bytes), at 96 2 x 9 F^2 P = 1,376 GFLOP -> 1.391 ms and at
// 128 2,446 GFLOP -> 2.473 ms (operations: past the card's ridge, where
// the 64-feature K1 sits); float32 K1 as six bf16 products 0.93, 8.35 and
// 14.84 ms; bf16 K2 at r = 4 0.232, 0.696 and 0.927 ms (operations);
// float32 K2 as the model calls it at these widths, on the split planes
// of its input (6 B a value read), at r = 2 0.513, 1.463 and 1.939 ms
// (bytes).  Both K2s read A from shared memory (the planes' fragments
// into registers in float32): at N 16-48 a m64nNk16 reads 2 KB of A and
// 32N B of B, 16 + N/4 clocks at 128 B a clock, more than its N/2 clocks
// of tensor work, so shared memory, not the tensor cores, sets their
// pace once the weights stop streaming.
//
// Both templates read the input in units of 32 channels: a unit's halo
// ((TH+2) x 66 pixels, one 64-B row a pixel, in the 64-B swizzle wgmma
// reads; a TMA box of 32 channels at channel 32u of a tensor map over the
// whole pixel, three boxes, one a plane, in float32).  A tap's A is the
// halo started whole 64-B rows later (dy * 66 + dx); its two k16 steps
// are 32 B apart in a row.  The weights are packed by the wrapper
// (kernels/conv3x3.py pack_weights_wide) as [unit][tap][split][k / 8][n]
// [8], K-major.  Each output pixel sums its K steps in the order (unit,
// tap, k16) in both templates, hi.hi apart from the five smaller products
// in float32 (conv3x3_f32_tc.cu's rule), so both give the same bits.
//
// Resident (`Res`, `conv3x3_wide_res_kernel`): K1 where the weights fit
// a block beside the halo ring: bf16 at 32 (18,432 B) and 96 (165,888 B),
// float32 at 32 (55,296 B); K2 (at R > 0, HeadEpilogue's staging beside)
// in bf16 at every form (at most 110,592 B, x4 at 128) and in float32 at
// 32 (`head_resident`).  What held the streamed design back there was its
// weights, streamed from L2 for every unit-tap of every tile behind a
// barrier (5.4 GB a bf16 K1 call at 96, 3.6 GB a bf16 K2 call at x4 and
// 128), and an epilogue that left the tensor cores idle (all warpgroups
// on one tile).  So:
//  * the weights come in once per block by one bulk copy and stay;
//  * consumer teams (two; four in bf16 K2 at x2) take the block's tiles
//    in turn, as rrdb_s8.cu's do: a team issues a tile's wgmmas only
//    after the team before it has issued its own (`turn`), so the halo
//    units are read in the order the producer loads them, and the other
//    teams' epilogues run beside a team's wgmmas;
//  * a warpgroup takes RPW rows (RPW wgmmas a k16 step, rows innermost so
//    each step's B descriptor serves them and dies), so a tile is TEAM_WGS
//    x RPW rows (`ResShape`): 8 at bf16 32 (halo 1.29x the tile, 4
//    slots), 2 at bf16 96 (48 accumulator registers a row; the weights
//    leave room for 3 slots of a 2-row halo only) and at float32 32 (3
//    slots of three planes; its A fragments read into registers by
//    ldmatrix, once for the six products that use them); K2's shapes are
//    `HeadShape`'s, float32 K2's A in registers a k16 step at a time
//    (`head_unit_regs`: eighteen groups a unit, the fragments in two sets
//    that alternate across units as well, so no unit waits for the last);
//  * one thread of a producer warpgroup issues the weight copy and every
//    halo unit, each once the team that read the unit HS before it
//    released it; a team issues a unit's wgmmas as one group and releases
//    the unit before it once that group is retired (wgmma_wait<1>), with a
//    predicated arrival: no branch on the thread index between a wgmma and
//    its wait.  setmaxnreg hands the producer's registers to the teams.
// Streamed (`Wide`, `conv3x3_wide_kernel`): float32 K2 at 96 and 128,
// bf16 K1 at 128 (294,912 B of weights) and float32 K1 at 96 and 128, the
// halo in two unit slots and the weights through a ring of four tap
// stages by bulk copies; the producer warpgroup as above; the warpgroups
// one output row of 64 pixels each (TH = 4, or 2 in float32 at N 96 and
// 128, whose acc and cor take 96 and 128 registers); each tap's release a
// predicated arrival after the wait that retires the tap before it.
// float32 K2 reads each plane's A fragments into registers once for
// their six products (`wide_tap_regs`, a group a k16 step), where the
// six wgmmas of a step read the same A from shared memory six times.
// Epilogues: K1 writes from the accumulator fragment (bf16 pairs; float32
// pairs and, where the caller passes `planes`, the hi, mid and lo bf16
// pairs of its value by tc.cuh's split2, the split pass's own arithmetic:
// the next layer's operand, so no split pass runs between hidden layers);
// K2's is tc.cuh's HeadEpilogue.
#pragma once

#include "tc.cuh"

namespace reve {
namespace wide {

using bf16 = __nv_bfloat16;
using namespace reve::tc;

constexpr int TW = 64;  // tile columns: the M of one wgmma
constexpr int CK = 32;  // input channels of a unit: one 64-B halo row

// PLANES: 1 (bfloat16) or 3 (float32's hi, mid, lo); CIN: the SRVGG's
// num_feat; R = 0: K1 (bias + PReLU, Cout = CIN), R = 2, 3, 4: K2 (u8
// residual + pixel shuffle at scale R).
template <int PLANES, int CIN, int R>
struct Wide {
  static constexpr bool F32 = PLANES == 3;
  using Epi = HeadEpilogue<R>;  // K2's; unused by K1
  static constexpr int COUT = R == 0 ? CIN : 3 * R * R;
  static constexpr int N = (COUT + 7) / 8 * 8;
  static constexpr int TH = F32 && N > 64 ? 2 : 4;
  static constexpr int THREADS = 128 * (TH + 1);  // + the producer
  // registers a thread: __launch_bounds__(THREADS, 1) caps each at 65,536
  // / THREADS rounded down to 8 (96 at TH 4, 168 at TH 2), and launch()
  // refuses a kernel that ptxas gave any other count; the producer
  // warpgroup hands most of its own to the consumers (rrdb.cu's budget:
  // setmaxnreg.inc waits until the block's own registers cover it, so a
  // budget the block does not hold would hang the card)
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS =
      ((TH + 1) * LAUNCH_REGS - PRODUCER_REGS) / TH / 8 * 8;
  static constexpr int UNITS = CIN / CK;
  // float32 K2: each plane's A fragments read into registers once for
  // their six products (wide_tap_regs)
  static constexpr bool AREGS = F32 && R > 0;
  static constexpr int HALO_TX = (TH + 2) * (TW + 2) * CK * 2;  // a plane
  static constexpr int HALO_BYTES = (HALO_TX + 1023) / 1024 * 1024;
  static constexpr int SLOT = PLANES * HALO_BYTES;  // a unit's halo
  static constexpr int SLOTS = 2;
  static constexpr int SPLIT_BYTES = CK * N * 2;  // a tap's weights, a split
  static constexpr int TAP_BYTES = PLANES * SPLIT_BYTES;
  static constexpr int STAGES = 4;  // weight ring
  // K2's staged output rows and input pixels, one area per warpgroup
  static constexpr int STAGE = R == 0 ? 0 : Epi::STAGE;
  static constexpr int ORIG = R == 0 ? 0 : Epi::ORIG;
  static constexpr size_t OFF_W = (size_t)SLOTS * SLOT;
  static constexpr size_t OFF_STAGE = OFF_W + (size_t)STAGES * TAP_BYTES;
  static constexpr size_t OFF_ORIG = OFF_STAGE + TH * STAGE;
  static constexpr size_t OFF_PAR = OFF_ORIG + TH * ORIG;  // bias, alpha
  static constexpr size_t OFF_BAR =
      (OFF_PAR + 2 * N * sizeof(float) + 7) / 8 * 8;
  // barriers: SLOTS full, SLOTS empty, STAGES full, STAGES empty
  static constexpr size_t SMEM =
      OFF_BAR + (2 * SLOTS + 2 * STAGES) * sizeof(uint64_t);
  static_assert(CIN % CK == 0, "Cin in whole units of 32 channels");
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
  static_assert(CONSUMER_REGS <= 256 &&
                    PRODUCER_REGS + TH * CONSUMER_REGS <=
                        (TH + 1) * LAUNCH_REGS,
                "more registers than the block was launched with");
  static_assert(SLOTS == 2 && STAGES == 4, "slots and stages by masks");
};

// One k16 step of a unit: `a` is the hi plane's A operand (mid and lo one
// and two halo planes later), `w` the stage's hi weights of the step (mid
// and lo one and two splits later).  bfloat16: one wgmma into `acc`;
// float32: hi.hi into `acc`, the five smaller products into `cor`,
// smallest first (conv3x3_f32_tc.cu's mma_bf16x6).
template <class K>
__device__ __forceinline__ void mma_step(float (&acc)[K::N / 2],
                                         float (&cor)[K::N / 2], uint32_t a,
                                         uint32_t w) {
  constexpr int N = K::N;
  const uint64_t ah = desc_sw64(a), bh = desc(w, N * 16);
  if constexpr (K::F32) {
    const uint64_t am = desc_sw64(a + K::HALO_BYTES),
                   al = desc_sw64(a + 2 * K::HALO_BYTES);
    const uint64_t bm = desc(w + K::SPLIT_BYTES, N * 16),
                   bl = desc(w + 2 * K::SPLIT_BYTES, N * 16);
    Wgmma<N>::mma(cor, al, bh);
    Wgmma<N>::mma(cor, ah, bl);
    Wgmma<N>::mma(cor, am, bm);
    Wgmma<N>::mma(cor, am, bh);
    Wgmma<N>::mma(cor, ah, bm);
  }
  Wgmma<N>::mma(acc, ah, bh);
}

template <class K>
__device__ __forceinline__ void fence_acc(float (&acc)[K::N / 2],
                                          float (&cor)[K::N / 2]) {
  fence_regs(acc);
  if constexpr (K::F32) fence_regs(cor);
}

// mma_step (a k16 step of one row) with A in registers: a[q] the
// fragments of planes hi, mid, lo.
template <class K>
__device__ __forceinline__ void res_step_regs(float (&acc)[K::N / 2],
                                              float (&cor)[K::N / 2],
                                              const uint32_t (&a)[3][4],
                                              uint32_t w) {
  constexpr int N = K::N;
  const uint64_t bh = desc(w, N * 16), bm = desc(w + K::SPLIT_BYTES, N * 16),
                 bl = desc(w + 2 * K::SPLIT_BYTES, N * 16);
  Wgmma<N>::mma(cor, a[2], bh);
  Wgmma<N>::mma(cor, a[0], bl);
  Wgmma<N>::mma(cor, a[1], bm);
  Wgmma<N>::mma(cor, a[1], bh);
  Wgmma<N>::mma(cor, a[0], bm);
  Wgmma<N>::mma(acc, a[0], bh);
}

// float32 K1's value pair (v0, v1) at element `at` of (B, H, W, F) into
// `out` (float32, if given) and its hi, mid and lo pairs into `planes`
// (three (B, H, W, F) bf16 planes `plane` elements apart, if given).
__device__ __forceinline__ void store_f32(float v0, float v1, long long at,
                                          float* out, bf16* planes,
                                          long long plane) {
  if (out != nullptr)
    *reinterpret_cast<float2*>(out + at) = make_float2(v0, v1);
  if (planes != nullptr) {
    uint32_t hi, mid, lo;
    split2(v0, v1, hi, mid, lo);
    *reinterpret_cast<uint32_t*>(planes + at) = hi;
    *reinterpret_cast<uint32_t*>(planes + plane + at) = mid;
    *reinterpret_cast<uint32_t*>(planes + 2 * plane + at) = lo;
  }
}

// A tap of float32 K2 with A in registers: its two k16 steps, each
// plane's fragments (ldmatrix at `a`, this lane's address of the tap's
// A) read once for its six products (res_step_regs), a set of registers
// a step.  The first step is a group of its own: the second's fragments
// load once the group before it (the tap before's second step) has
// retired.  The caller commits the second step.
template <class K>
__device__ __forceinline__ void wide_tap_regs(float (&acc)[K::N / 2],
                                              float (&cor)[K::N / 2],
                                              uint32_t (&af)[CK / 16][3][4],
                                              uint32_t a, uint32_t ws) {
#pragma unroll
  for (int kc = 0; kc < CK / 16; ++kc) {
    if (kc > 0) {
      wgmma_commit();
      fence_acc<K>(acc, cor);
      wgmma_wait<1>();
#pragma unroll
      for (int q = 0; q < 3; ++q) fence_regs(af[kc][q]);
    }
#pragma unroll
    for (int q = 0; q < 3; ++q)
      ldmatrix_x4(af[kc][q], swizzle<64>(a + q * K::HALO_BYTES + kc * 32));
    wgmma_fence();
    res_step_regs<K>(acc, cor, af[kc], ws + 2 * kc * K::N * 16);
  }
}

// `x`: the input's tensor map (B images, or the three planes' 3B);
// `w`: the packed weights, [unit][tap][split][k / 8][n][8] bf16;
// `planes`: float32 K1's output planes (or null; K2 and bf16 ignore it).
template <int PLANES, int CIN, int R>
__global__ void __launch_bounds__(Wide<PLANES, CIN, R>::THREADS, 1)
conv3x3_wide_kernel(const __grid_constant__ CUtensorMap map,
                    const bf16* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ alpha,
                    const uint8_t* __restrict__ orig,
                    void* __restrict__ out, bf16* __restrict__ planes,
                    int B, int H, int W) {
  using K = Wide<PLANES, CIN, R>;
  using Epi = typename K::Epi;
  constexpr int N = K::N, COUT = K::COUT, TH = K::TH, UNITS = K::UNITS;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;  // warpgroup = tile row

  float* bs = reinterpret_cast<float*>(smem + K::OFF_PAR);
  float* as = bs + N;
  for (int i = tid; i < N; i += K::THREADS) {
    bs[i] = i < COUT ? bias[i] : 0.f;
    as[i] = R == 0 ? alpha[i] : 0.f;
  }
  const uint32_t h_full = base + (uint32_t)K::OFF_BAR;
  const uint32_t h_empty = h_full + 8 * K::SLOTS;
  const uint32_t w_full = h_empty + 8 * K::SLOTS;
  const uint32_t w_empty = w_full + 8 * K::STAGES;
  if (tid == 0) {
    for (int s = 0; s < K::SLOTS; ++s) {
      mbar_init(h_full + 8 * s, 1);
      mbar_init(h_empty + 8 * s, TH);
    }
    for (int s = 0; s < K::STAGES; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, TH);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const TileGrid<TH, TW> g(B, H, W);

  if (wg == TH) {
    // The producer: one thread issues every copy.  Unit hu (the block's
    // hu-th) goes to slot hu % SLOTS once the warpgroups released unit hu
    // - SLOTS; weight stage gi (tap gi % 9 of the block's unit gi / 9)
    // once they released stage gi - STAGES.
    setmaxnreg_dec<K::PRODUCER_REGS>();
    if (t != 0) return;
    uint32_t hu = 0, gi = 0;
    for (long long tile = blockIdx.x; tile < g.count; tile += gridDim.x) {
      int b, y0, x0;
      g.origin(tile, b, y0, x0);
      for (int u = 0; u < UNITS; ++u, ++hu) {
        const uint32_t hs = hu & 1;
        if (hu >= K::SLOTS)
          mbar_wait(h_empty + 8 * hs, ((hu >> 1) - 1) & 1);
        mbar_expect_tx(h_full + 8 * hs, PLANES * K::HALO_TX);
        for (int q = 0; q < PLANES; ++q)
          tma_load_4d(base + hs * K::SLOT + q * K::HALO_BYTES, &map,
                      h_full + 8 * hs, u * CK, x0 - 1, y0 - 1, q * B + b);
        for (int tap = 0; tap < 9; ++tap, ++gi) {
          const uint32_t s = gi & 3;
          if (gi >= K::STAGES) mbar_wait(w_empty + 8 * s, ((gi >> 2) - 1) & 1);
          mbar_expect_tx(w_full + 8 * s, K::TAP_BYTES);
          bulk_load(base + (uint32_t)(K::OFF_W + s * K::TAP_BYTES),
                    w + (size_t)(u * 9 + tap) * (K::TAP_BYTES / 2),
                    K::TAP_BYTES, w_full + 8 * s);
        }
      }
    }
    return;
  }

  // The warpgroups: taps unrolled, each release a predicated arrival.
  setmaxnreg_inc<K::CONSUMER_REGS>();
  const int lane = t & 31;
  const int p0 = (t >> 5) * 16 + (lane >> 2), c0 = (lane & 3) * 2;
  // ldmatrix (AREGS): this lane's row of the warp's 16 and its 16-B half
  const uint32_t lm =
      ((t >> 5) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * CK * 2 +
      (lane >> 4) * 16;
  // the block's units (hu) and unit-taps (gi) before this one
  uint32_t hu = 0, gi = 0;
  for (long long tile = blockIdx.x; tile < g.count; tile += gridDim.x) {
    int b, y0, x0;
    g.origin(tile, b, y0, x0);
    const int oy = y0 + wg;
    const int valid = min(TW, W - x0);  // pixels of this row in the frame
    // K2 reads the row's u8 input pixels before the wgmmas; the loads
    // land while the tensor cores work
    uint8_t o0 = 0, o1 = 0;
    if constexpr (R > 0)
      Epi::load_orig(orig, b, oy, x0, H, W, valid, t, o0, o1);
    float acc[N / 2], cor[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = cor[i] = 0.f;
    uint32_t af[CK / 16][3][4];  // AREGS: a set a k16 step
#pragma unroll 1
    for (int u = 0; u < UNITS; ++u, ++hu) {
      const uint32_t hs = hu & 1;
      mbar_wait(h_full + 8 * hs, (hu >> 1) & 1);
      const uint32_t a_row = base + hs * K::SLOT + wg * (TW + 2) * CK * 2;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap, ++gi) {
        const uint32_t s = gi & 3;
        mbar_wait(w_full + 8 * s, (gi >> 2) & 1);
        const uint32_t a = a_row + ((tap / 3) * (TW + 2) + tap % 3) * CK * 2;
        const uint32_t ws = base + (uint32_t)(K::OFF_W + s * K::TAP_BYTES);
        fence_acc<K>(acc, cor);
        if constexpr (K::AREGS) {
          wide_tap_regs<K>(acc, cor, af, a + lm, ws);
        } else {
          wgmma_fence();
#pragma unroll
          for (int kc = 0; kc < CK / 16; ++kc)
            mma_step<K>(acc, cor, a + kc * 32, ws + 2 * kc * N * 16);
        }
        wgmma_commit();
        fence_acc<K>(acc, cor);
        // the tap before this one is done: release its stage (none
        // before the tile's first), and at a unit's first tap the last
        // unit's halo slot (AREGS: this tap's first k16 step is done, its
        // set of registers free)
        wgmma_wait<1>();
        mbar_arrive_if(w_empty + 8 * ((gi - 1) & 3),
                       t == 0 && (tap > 0 || u > 0));
        if (tap == 0)
          mbar_arrive_if(h_empty + 8 * ((hu - 1) & 1), t == 0 && u > 0);
        if constexpr (K::AREGS)
#pragma unroll
          for (int q = 0; q < 3; ++q) fence_regs(af[0][q]);
      }
    }
    // the tile's last tap, and its last unit's halo slot
    wgmma_wait<0>();
    mbar_arrive_if(w_empty + 8 * ((gi - 1) & 3), t == 0);
    mbar_arrive_if(h_empty + 8 * ((hu - 1) & 1), t == 0);
    fence_acc<K>(acc, cor);
    if constexpr (K::AREGS)
#pragma unroll
      for (int kc = 0; kc < CK / 16; ++kc)
#pragma unroll
        for (int q = 0; q < 3; ++q) fence_regs(af[kc][q]);

    // accumulator fragment: register 4j + 2h + e holds pixel
    // 16 * warp + lane / 4 + 8h, channel 8j + 2 * (lane % 4) + e
    if constexpr (R == 0) {
      if (oy < H) {
        const long long row = ((long long)b * H + oy) * W;
#pragma unroll
        for (int j = 0; j < COUT / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = p0 + 8 * h, c = 8 * j + c0;
            if (x0 + p >= W) continue;
            const int q = 4 * j + 2 * h;
            const long long at = (row + x0 + p) * COUT + c;
            if constexpr (K::F32) {
              // conv + b in float32; PReLU in float32:
              // max(v, 0) + alpha * min(v, 0)
              float v0 = __fadd_rn(__fadd_rn(acc[q], cor[q]), bs[c]);
              float v1 =
                  __fadd_rn(__fadd_rn(acc[q + 1], cor[q + 1]), bs[c + 1]);
              v0 = v0 > 0.f ? v0 : __fmul_rn(as[c], v0);
              v1 = v1 > 0.f ? v1 : __fmul_rn(as[c + 1], v1);
              store_f32(v0, v1, at, static_cast<float*>(out), planes,
                        (long long)B * H * W * COUT);
            } else {
              // (acc + b) in float32, cast to bf16; PReLU in bf16:
              // max(v, 0) + bf16(alpha * min(v, 0))
              __nv_bfloat162 y2;
              float f = round_to<bf16>(__fadd_rn(acc[q], bs[c]));
              y2.x = __float2bfloat16_rn(f > 0.f ? f : __fmul_rn(as[c], f));
              f = round_to<bf16>(__fadd_rn(acc[q + 1], bs[c + 1]));
              y2.y = __float2bfloat16_rn(f > 0.f ? f
                                                 : __fmul_rn(as[c + 1], f));
              *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) +
                                                 at) = y2;
            }
          }
      }
    } else {
      // conv + b in float32 (bf16: cast to bf16), then the residual
      Epi::template row<N>(
          smem + K::OFF_STAGE + wg * K::STAGE,
          smem + K::OFF_ORIG + wg * K::ORIG, static_cast<uint8_t*>(out), b,
          oy, x0, H, W, valid, wg, t, o0, o1, [&](int q, int kk) {
            if constexpr (K::F32)
              return __fadd_rn(__fadd_rn(acc[q], cor[q]), bs[kk]);
            else
              return round_to<bf16>(__fadd_rn(acc[q], bs[kk]));
          });
    }
  }
}

template <int PLANES, int CIN, int R>
cudaError_t launch(const void* x, const void* w, const float* b,
                   const float* alpha, const uint8_t* orig, void* out, int B,
                   int H, int W, cudaStream_t stream,
                   void* planes = nullptr) {
  using K = Wide<PLANES, CIN, R>;
  const long long tiles =
      (long long)B * ((H + K::TH - 1) / K::TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  CUtensorMap map;
  cudaError_t err = halo_map(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x,
                             PLANES * B, H, W, TW + 2, K::TH + 2,
                             CU_TENSOR_MAP_SWIZZLE_64B, CK, CIN);
  if (err != cudaSuccess) return err;
  auto kernel = conv3x3_wide_kernel<PLANES, CIN, R>;
  // the registers setmaxnreg redistributes are those the block launched
  // with: any other count than the budget's would hang the card
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs != K::LAUNCH_REGS) return cudaErrorLaunchOutOfResources;
  int grid = 0;
  err = reve::persistent_grid(kernel, K::THREADS, K::SMEM, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, K::THREADS, K::SMEM, stream>>>(
      map, static_cast<const bf16*>(w), b, alpha, orig, out,
      static_cast<bf16*>(planes), B, H, W);
  return cudaGetLastError();
}

// The resident kernel's shape: TEAMS teams of TEAM_WGS warpgroups of RPW
// rows each, HS halo slots; AREGS (float32): the A fragments of the
// three planes read into registers (ldmatrix) once for their six
// products, in two sets of registers a tap (K1) or a k16 step (K2) each.
template <int TEAM_WGS_, int RPW_, int HS_, bool AREGS_ = false,
          int TEAMS_ = 2>
struct Shape {
  static constexpr int TEAM_WGS = TEAM_WGS_, RPW = RPW_, HS = HS_;
  static constexpr bool AREGS = AREGS_;
  static constexpr int TEAMS = TEAMS_;
};

// R = 0: K1 (bias + PReLU, Cout = Cin, a multiple of 32); R = 2, 3, 4:
// K2 (u8 residual + pixel shuffle at scale R, Cout 3R^2 padded to N).
template <int PLANES, int CIN, class S, int R = 0>
struct Res {
  static constexpr bool F32 = PLANES == 3;
  using Epi = HeadEpilogue<R>;  // K2's; unused by K1
  static constexpr int COUT = R == 0 ? CIN : 3 * R * R;
  static constexpr int N = (COUT + 7) / 8 * 8;
  static constexpr int TEAMS = S::TEAMS;
  static constexpr int TEAM_WGS = S::TEAM_WGS, RPW = S::RPW, HS = S::HS;
  static constexpr bool AREGS = S::AREGS;
  static constexpr int WGS = TEAMS * TEAM_WGS;
  static constexpr int TH = TEAM_WGS * RPW;  // tile rows
  static constexpr int THREADS = 128 * (WGS + 1);  // + the producer
  // registers a thread, as Wide's: launch() refuses a kernel that ptxas
  // gave another count than LAUNCH_REGS
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int SPARE =
      ((WGS + 1) * LAUNCH_REGS - PRODUCER_REGS) / WGS / 8 * 8;
  static constexpr int CONSUMER_REGS = SPARE > 256 ? 256 : SPARE;
  static constexpr int UNITS = CIN / CK;
  static constexpr int HALO_TX = (TH + 2) * (TW + 2) * CK * 2;  // a plane
  static constexpr int HALO_BYTES = (HALO_TX + 1023) / 1024 * 1024;
  static constexpr int SLOT = PLANES * HALO_BYTES;  // a unit's halo
  static constexpr int SLOT_TX = PLANES * HALO_TX;  // ... its copies' bytes
  static constexpr int SPLIT_BYTES = CK * N * 2;    // a tap's weights, a split
  static constexpr int TAP_BYTES = PLANES * SPLIT_BYTES;
  static constexpr int W_BYTES = UNITS * 9 * TAP_BYTES;  // all of them
  static constexpr size_t OFF_W = (size_t)HS * SLOT;
  static constexpr size_t OFF_PAR = OFF_W + W_BYTES;  // bias, alpha
  // K2's staged output rows and input pixels, one area per warpgroup
  static constexpr int STAGE = R == 0 ? 0 : Epi::STAGE;
  static constexpr int ORIG = R == 0 ? 0 : Epi::ORIG;
  static constexpr size_t OFF_STAGE = OFF_PAR + 2 * N * sizeof(float);
  static constexpr size_t OFF_ORIG = OFF_STAGE + WGS * STAGE;
  static constexpr size_t OFF_BAR = (OFF_ORIG + WGS * ORIG + 7) / 8 * 8;
  // barriers: HS full, HS empty, the weights', a team's turn each
  static constexpr size_t SMEM =
      OFF_BAR + (2 * HS + 1 + TEAMS) * sizeof(uint64_t);
  static_assert(CIN % CK == 0, "Cin in whole units of 32 channels");
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
  static_assert(OFF_PAR % 16 == 0 && OFF_BAR % 8 == 0,
                "16-B weights and parameters, 8-B barriers");
  static_assert(PRODUCER_REGS + WGS * CONSUMER_REGS <=
                    (WGS + 1) * LAUNCH_REGS,
                "more registers than the block was launched with");
  static_assert(!S::AREGS || (F32 && N <= 48),
                "A in registers: float32 at N 16, 32 or 48 (Wgmma's forms)");
};

// The resident K1's shape at each width, the fastest of those tried on an
// H100 SXM (teams of one or two warpgroups of one to eight rows, 2 to 6
// slots): bf16 32 teams of two warpgroups of four rows, 4 slots; bf16 96
// of one row each, 3 slots (the weights take 165,888 B; at two rows a
// warpgroup 96 accumulator registers would spill); float32 32 of one row
// each, 3 slots of three planes, A in registers (from shared memory each
// m64n32k16 reads 2 KB of A for 1 KB of B: six of them a k16 step read
// more than shared memory delivers in their time; two rows a warpgroup
// spilled).
template <int PLANES, int CIN>
struct ResShape;
template <>
struct ResShape<1, 32> : Shape<2, 4, 4> {};
template <>
struct ResShape<1, 96> : Shape<2, 1, 3> {};
template <>
struct ResShape<3, 32> : Shape<2, 1, 3, true> {};

// Whether K2 at (PLANES, CIN, R) runs on the resident kernel
// (HeadShape): bf16 at every form (its weights at most 110,592 B, x4 at
// 128) and float32 at 32 (at most 82,944 B, x4).  float32 at 96 and 128
// streams its weights (Wide): x3 and x4 (165,888 to 331,776 B) do not
// fit, and x2, which fits only beside 2-row tiles of three planes (the
// halo read 2x), was slower resident than streamed with its 4-row tiles
// on an H100 SXM (perf_conv_tc_parts' `resident` variant).
template <int PLANES, int CIN, int R>
constexpr bool head_resident() {
  return PLANES == 1 || CIN == 32;
}

// The resident K2's shape, the fastest of those tried on an H100 SXM
// (teams of one or two warpgroups of one to four rows, 2 to 4 teams,
// 2 to 4 slots): bf16 teams of two warpgroups of two rows (4-row tiles,
// the halo read 1.5x), 4 slots, at x2 (N 16, an epilogue of 12 bytes a
// pixel against 9 taps of 8-register accumulators) four teams of one
// warpgroup of four rows, so that three teams' epilogues run beside one
// team's wgmmas; float32 A in registers, teams of two warpgroups of one
// row (2-row tiles: three planes of a 4-row halo beside the weights
// leave room for 2 or 3 slots).
template <int PLANES, int CIN, int R>
struct HeadShape : Shape<2, 2, 4> {};
template <int CIN>
struct HeadShape<1, CIN, 2> : Shape<1, 4, 4, false, 4> {};
template <int CIN, int R>
struct HeadShape<3, CIN, R>
    : Shape<2, 1, CIN == 32 && R < 4 ? 3 : 2, true> {};

template <class K>
__device__ __forceinline__ void res_fence(
    float (&acc)[K::RPW][K::N / 2],
    float (&cor)[K::RPW][K::N / 2]) {
#pragma unroll
  for (int s = 0; s < K::RPW; ++s) {
    fence_regs(acc[s]);
    if constexpr (K::F32) fence_regs(cor[s]);
  }
}

// K2's A fragments in registers: two sets, one a k16 step of a tap (kc),
// of the RPW rows' planes hi, mid, lo.
template <class K>
using StepFrags = uint32_t[2][K::RPW][3][4];

// K2's unit with A in registers (`lm`: this lane's ldmatrix row and 16-B
// half, in bytes): a group a k16 step, its fragments in set kc, so that
// the sets alternate across units too (18 steps a unit) and the steps
// run on with no wait between units; each step's fragments load once the
// step before the last has retired.  After the unit's first step the
// last step of the unit before is retired, and `release` arrives for its
// slot where `pred` holds.
template <class K>
__device__ __forceinline__ void head_unit_regs(
    float (&acc)[K::RPW][K::N / 2],
    float (&cor)[K::RPW][K::N / 2], StepFrags<K>& af, uint32_t a_rows,
    uint32_t wu, uint32_t lm, uint32_t release, bool pred) {
  constexpr int RPW = K::RPW;
  res_fence<K>(acc, cor);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int kc = 0; kc < CK / 16; ++kc) {
#pragma unroll
      for (int s = 0; s < RPW; ++s)
#pragma unroll
        for (int q = 0; q < 3; ++q)
          ldmatrix_x4(af[kc][s][q],
                      swizzle<64>(a_rows + q * K::HALO_BYTES +
                                  ((s + tap / 3) * (TW + 2) + tap % 3) *
                                      CK * 2 +
                                  kc * 32 + lm));
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < RPW; ++s)
        res_step_regs<K>(acc[s], cor[s], af[kc][s],
                         wu + tap * K::TAP_BYTES + 2 * kc * K::N * 16);
      wgmma_commit();
      res_fence<K>(acc, cor);
      // the step before is done: the other set's registers are free
      wgmma_wait<1>();
      if (tap == 0 && kc == 0) mbar_arrive_if(release, pred);
#pragma unroll
      for (int s = 0; s < RPW; ++s)
#pragma unroll
        for (int q = 0; q < 3; ++q) fence_regs(af[kc ^ 1][s][q]);
    }
}

// The wgmmas of one unit into the warpgroup's RPW rows, one group:
// `a_rows` its first halo row in the slot, `wu` the unit's weights.  With
// A in registers (`lm`: this lane's ldmatrix row and 16-B half, in
// bytes), a group a tap, the tap before waited on (wgmma_wait<1>) before
// its fragments' registers are loaded again.
template <class K>
__device__ __forceinline__ void res_unit(
    float (&acc)[K::RPW][K::N / 2],
    float (&cor)[K::RPW][K::N / 2], uint32_t a_rows,
    uint32_t wu, uint32_t lm) {
  constexpr int RPW = K::RPW;
  res_fence<K>(acc, cor);
  if constexpr (K::AREGS) {
    uint32_t af[2][RPW][CK / 16][3][4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int h = tap & 1;
#pragma unroll
      for (int s = 0; s < RPW; ++s)
#pragma unroll
        for (int kc = 0; kc < CK / 16; ++kc)
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const uint32_t a = a_rows + q * K::HALO_BYTES +
                               ((s + tap / 3) * (TW + 2) + tap % 3) * CK * 2 +
                               kc * 32 + lm;
            ldmatrix_x4(af[h][s][kc][q], swizzle<64>(a));
          }
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < CK / 16; ++kc)
#pragma unroll
        for (int s = 0; s < RPW; ++s)
          res_step_regs<K>(acc[s], cor[s], af[h][s][kc],
                           wu + tap * K::TAP_BYTES + 2 * kc * K::N * 16);
      wgmma_commit();
      res_fence<K>(acc, cor);
      // the tap before is done: its fragments' registers are free
      wgmma_wait<1>();
#pragma unroll
      for (int s = 0; s < RPW; ++s)
#pragma unroll
        for (int kc = 0; kc < CK / 16; ++kc)
#pragma unroll
          for (int q = 0; q < 3; ++q) fence_regs(af[h ^ 1][s][kc][q]);
    }
    // the last tap's fragments stay live until its wgmmas are done
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < RPW; ++s)
#pragma unroll
      for (int kc = 0; kc < CK / 16; ++kc)
#pragma unroll
        for (int q = 0; q < 3; ++q) fence_regs(af[0][s][kc][q]);
    res_fence<K>(acc, cor);
  } else {
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int kc = 0; kc < CK / 16; ++kc)
#pragma unroll
        for (int s = 0; s < RPW; ++s)
          mma_step<K>(acc[s], cor[s],
                      a_rows + ((s + tap / 3) * (TW + 2) + tap % 3) * CK * 2 +
                          kc * 32,
                      wu + tap * K::TAP_BYTES + 2 * kc * K::N * 16);
    wgmma_commit();
    res_fence<K>(acc, cor);
  }
}

// The bf16 pairs of one 32-channel group of a pixel (m[j]: channels 32g +
// 8j + 2 (lane % 4) + {0, 1}) written at `dst` (the pixel's channel 32g)
// as 4-B pairs.  (Turned around across each quad of lanes first and
// written as one 16-B vector a lane, as rrdb.cu's quad_transpose does,
// every form took longer on an H100 SXM.)
__device__ __forceinline__ void store_group(const uint32_t (&m)[4], bf16* dst,
                                            int c0) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<uint32_t*>(dst + 8 * j + c0) = m[j];
}

// `map`: the input's tensor map (B images, or the three planes' 3B); `w`:
// the packed weights; `out`: K1's output (bf16, or float32 where given),
// K2's u8 output; `planes`: float32 K1's output planes (or null); `orig`:
// K2's u8 input frames (K1: null).
template <int PLANES, int CIN, class S, int R>
__global__ void __launch_bounds__(Res<PLANES, CIN, S, R>::THREADS, 1)
conv3x3_wide_res_kernel(const __grid_constant__ CUtensorMap map,
                        const bf16* __restrict__ w,
                        const float* __restrict__ bias,
                        const float* __restrict__ alpha,
                        const uint8_t* __restrict__ orig,
                        void* __restrict__ out, bf16* __restrict__ planes,
                        int B, int H, int W) {
  using K = Res<PLANES, CIN, S, R>;
  using Epi = typename K::Epi;
  constexpr int N = K::N, UNITS = K::UNITS, WGS = K::WGS, HS = K::HS;
  constexpr int TEAM_WGS = K::TEAM_WGS, RPW = K::RPW;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;

  float* bs = reinterpret_cast<float*>(smem + K::OFF_PAR);
  float* as = bs + N;
  for (int i = tid; i < N; i += K::THREADS) {
    bs[i] = i < K::COUT ? bias[i] : 0.f;
    as[i] = R == 0 ? alpha[i] : 0.f;
  }
  const uint32_t h_full = base + (uint32_t)K::OFF_BAR;
  const uint32_t h_empty = h_full + 8 * HS;
  const uint32_t w_full = h_empty + 8 * HS;
  const uint32_t turn = w_full + 8;  // + 8 * team
  if (tid == 0) {
    for (int s = 0; s < HS; ++s) {
      mbar_init(h_full + 8 * s, 1);
      mbar_init(h_empty + 8 * s, TEAM_WGS);
    }
    mbar_init(w_full, 1);
    for (int m = 0; m < K::TEAMS; ++m) mbar_init(turn + 8 * m, TEAM_WGS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const TileGrid<K::TH, TW> g(B, H, W);

  if (wg == WGS) {
    // The producer: one thread issues the weights' copy, then every halo
    // unit in the order the teams read them: the block's gh-th unit
    // (unit gh % UNITS of its tile gh / UNITS) goes to slot gh % HS once
    // the team that read unit gh - HS released it.
    setmaxnreg_dec<K::PRODUCER_REGS>();
    if (t != 0) return;
    mbar_expect_tx(w_full, K::W_BYTES);
    bulk_load(base + (uint32_t)K::OFF_W, w, K::W_BYTES, w_full);
    uint32_t gh = 0;
    for (long long tile = blockIdx.x; tile < g.count; tile += gridDim.x) {
      int b, y0, x0;
      g.origin(tile, b, y0, x0);
      for (int u = 0; u < UNITS; ++u, ++gh) {
        const uint32_t hs = gh % HS;
        if (gh >= HS) mbar_wait(h_empty + 8 * hs, (gh / HS - 1) & 1);
        mbar_expect_tx(h_full + 8 * hs, K::SLOT_TX);
        for (int q = 0; q < PLANES; ++q)
          tma_load_4d(base + hs * K::SLOT + q * K::HALO_BYTES, &map,
                      h_full + 8 * hs, u * CK, x0 - 1, y0 - 1, q * B + b);
      }
    }
    return;
  }

  // The teams: team m takes the block's tiles m, m + TEAMS, ...; its
  // wgmmas follow those of the team before it, m - 1 (`turn`).
  setmaxnreg_inc<K::CONSUMER_REGS>();
  const int team = wg / TEAM_WGS;
  const int r0 = (wg % TEAM_WGS) * RPW;  // the warpgroup's first tile row
  const int lane = t & 31;
  const int p0 = (t >> 5) * 16 + (lane >> 2), c0 = (lane & 3) * 2;
  // ldmatrix (AREGS): this lane's row of the warp's 16 and its 16-B half
  const uint32_t lm =
      ((t >> 5) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * CK * 2 +
      (lane >> 4) * 16;
  const long long plane = (long long)B * H * W * N;
  mbar_wait(w_full, 0);
  int j = 0;  // the team's tiles so far
  for (long long tile = blockIdx.x + team * gridDim.x; tile < g.count;
       tile += K::TEAMS * gridDim.x, ++j) {
    // the block's tile index
    const long long kk = (long long)K::TEAMS * j + team;
    int b, y0, x0;
    g.origin(tile, b, y0, x0);
    const int valid = min(TW, W - x0);  // pixels of a row in the frame
    // K2 reads its rows' u8 input pixels first; the loads land while the
    // team waits for its turn and the tensor cores work
    uint8_t o0[RPW], o1[RPW];
    if constexpr (R > 0)
#pragma unroll
      for (int s = 0; s < RPW; ++s)
        Epi::load_orig(orig, b, y0 + r0 + s, x0, H, W, valid, t, o0[s],
                       o1[s]);
    // the team before has issued its wgmmas of the block's tile kk - 1
    if (kk > 0)
      mbar_wait(turn + 8 * team,
                (uint32_t)((K::TEAMS == 2 ? j - 1 + team : j - (team == 0)) &
                           1));
    float acc[RPW][N / 2], cor[RPW][N / 2];  // cor: float32's
#pragma unroll
    for (int s = 0; s < RPW; ++s)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[s][i] = cor[s][i] = 0.f;
    uint32_t gh = (uint32_t)kk * UNITS;  // the block's unit
    StepFrags<K> af;  // K2 with A in registers: across the tile's units
#pragma unroll 1
    for (int u = 0; u < UNITS; ++u, ++gh) {
      const uint32_t hs = gh % HS;
      mbar_wait(h_full + 8 * hs, (gh / HS) & 1);
      if constexpr (K::AREGS && R > 0) {
        head_unit_regs<K>(
            acc, cor, af, base + hs * K::SLOT + r0 * (TW + 2) * CK * 2,
            base + (uint32_t)(K::OFF_W + u * 9 * K::TAP_BYTES), lm,
            h_empty + 8 * ((gh + HS - 1) % HS), t == 0 && u > 0);
        continue;
      }
      res_unit<K>(acc, cor, base + hs * K::SLOT + r0 * (TW + 2) * CK * 2,
                  base + (uint32_t)(K::OFF_W + u * 9 * K::TAP_BYTES), lm);
      // the unit before this one is done: release its slot
      wgmma_wait<1>();
      mbar_arrive_if(h_empty + 8 * ((gh + HS - 1) % HS), t == 0 && u > 0);
    }
    // the next team's turn; then this tile's last wgmmas and its slot
    mbar_arrive_if(
        turn + 8 * (K::TEAMS == 2 ? 1 - team : (team + 1) % K::TEAMS),
        t == 0);
    wgmma_wait<0>();
    res_fence<K>(acc, cor);
    if constexpr (K::AREGS && R > 0)
#pragma unroll
      for (int s = 0; s < RPW; ++s)
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          fence_regs(af[0][s][q]);
          fence_regs(af[1][s][q]);
        }
    mbar_arrive_if(h_empty + 8 * ((gh - 1) % HS), t == 0);

    // accumulator fragment: register 4j + 2h + e of row s holds pixel
    // 16 * warp + lane / 4 + 8h, channel 8j + 2 * (lane % 4) + e
    if constexpr (R > 0) {
      // K2: conv + b in float32 (bf16: cast to bf16), then the residual,
      // a row at a time through the warpgroup's staging area
#pragma unroll
      for (int s = 0; s < RPW; ++s)
        Epi::template row<N>(
            smem + K::OFF_STAGE + wg * K::STAGE,
            smem + K::OFF_ORIG + wg * K::ORIG, static_cast<uint8_t*>(out),
            b, y0 + r0 + s, x0, H, W, valid, wg, t, o0[s], o1[s],
            [&](int q, int c) {
              if constexpr (K::F32)
                return __fadd_rn(__fadd_rn(acc[s][q], cor[s][q]), bs[c]);
              else
                return round_to<bf16>(__fadd_rn(acc[s][q], bs[c]));
            });
      continue;
    }
#pragma unroll
    for (int s = 0; s < RPW; ++s) {
      const int oy = y0 + r0 + s;
      if (oy >= H) continue;
      const long long row = ((long long)b * H + oy) * W;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + 8 * h;
        if (x0 + p >= W) continue;
        const long long px = (row + x0 + p) * N;
#pragma unroll
        for (int g32 = 0; g32 < N / 32; ++g32) {
          // the group's four pairs: hi, mid, lo (float32) or the bf16
          // output
          uint32_t m[3][4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int c = 32 * g32 + 8 * jj + c0, q = 4 * (4 * g32 + jj) + 2 * h;
            const float2 bi = *reinterpret_cast<const float2*>(bs + c);
            const float2 al = *reinterpret_cast<const float2*>(as + c);
            if constexpr (K::F32) {
              // conv + b in float32; PReLU in float32:
              // max(v, 0) + alpha * min(v, 0)
              float v0 = __fadd_rn(__fadd_rn(acc[s][q], cor[s][q]), bi.x);
              float v1 =
                  __fadd_rn(__fadd_rn(acc[s][q + 1], cor[s][q + 1]), bi.y);
              v0 = v0 > 0.f ? v0 : __fmul_rn(al.x, v0);
              v1 = v1 > 0.f ? v1 : __fmul_rn(al.y, v1);
              if (out != nullptr)
                *reinterpret_cast<float2*>(static_cast<float*>(out) + px +
                                           c) = make_float2(v0, v1);
              split2(v0, v1, m[0][jj], m[1][jj], m[2][jj]);
            } else {
              // (acc + b) in float32, cast to bf16; PReLU in bf16:
              // max(v, 0) + bf16(alpha * min(v, 0))
              __nv_bfloat162 y2;
              float f = round_to<bf16>(__fadd_rn(acc[s][q], bi.x));
              y2.x = __float2bfloat16_rn(f > 0.f ? f : __fmul_rn(al.x, f));
              f = round_to<bf16>(__fadd_rn(acc[s][q + 1], bi.y));
              y2.y = __float2bfloat16_rn(f > 0.f ? f : __fmul_rn(al.y, f));
              m[0][jj] = *reinterpret_cast<const uint32_t*>(&y2);
            }
          }
          if constexpr (K::F32) {
            if (planes != nullptr)
#pragma unroll
              for (int pl = 0; pl < 3; ++pl)
                store_group(m[pl], planes + pl * plane + px + 32 * g32, c0);
          } else {
            store_group(m[0], static_cast<bf16*>(out) + px + 32 * g32, c0);
          }
        }
      }
    }
  }
}

template <int PLANES, int CIN, class S, int R = 0>
cudaError_t launch_res(const void* x, const void* w, const float* b,
                       const float* alpha, void* out, void* planes, int B,
                       int H, int W, cudaStream_t stream,
                       const uint8_t* orig = nullptr) {
  using K = Res<PLANES, CIN, S, R>;
  const long long tiles =
      (long long)B * ((H + K::TH - 1) / K::TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  CUtensorMap map;
  cudaError_t err = halo_map(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x,
                             PLANES * B, H, W, TW + 2, K::TH + 2,
                             CU_TENSOR_MAP_SWIZZLE_64B, CK, CIN);
  if (err != cudaSuccess) return err;
  auto kernel = conv3x3_wide_res_kernel<PLANES, CIN, S, R>;
  // the registers setmaxnreg redistributes are those the block launched
  // with: any other count than the budget's would hang the card
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs != K::LAUNCH_REGS) return cudaErrorLaunchOutOfResources;
  int grid = 0;
  err = reve::persistent_grid(kernel, K::THREADS, K::SMEM, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, K::THREADS, K::SMEM, stream>>>(
      map, static_cast<const bf16*>(w), b, alpha, orig, out,
      static_cast<bf16*>(planes), B, H, W);
  return cudaGetLastError();
}

// The resident K1 at its width's shape (ResShape).
template <int PLANES, int CIN>
cudaError_t k1_res(const void* x, const void* w, const float* b,
                   const float* alpha, void* y, void* planes, int B, int H,
                   int W, cudaStream_t s) {
  return launch_res<PLANES, CIN, ResShape<PLANES, CIN>>(x, w, b, alpha, y,
                                                        planes, B, H, W, s);
}

// K1 at `feat` (32, 96, 128) input and output channels: resident at bf16
// 32 and 96 and float32 32, streamed at the others.  `y`: the output
// (float32: may be null); `planes`: float32's output planes (or null).
template <int PLANES>
cudaError_t k1(const void* x, const void* w, const float* b,
               const float* alpha, void* y, void* planes, int B, int H,
               int W, int feat, cudaStream_t s) {
  switch (feat) {
    case 32: return k1_res<PLANES, 32>(x, w, b, alpha, y, planes, B, H, W,
                                       s);
    case 96:
      if constexpr (PLANES == 1)
        return k1_res<PLANES, 96>(x, w, b, alpha, y, planes, B, H, W, s);
      else
        return launch<PLANES, 96, 0>(x, w, b, alpha, nullptr, y, B, H, W, s,
                                     planes);
    case 128: return launch<PLANES, 128, 0>(x, w, b, alpha, nullptr, y, B,
                                            H, W, s, planes);
    default: return cudaErrorInvalidValue;
  }
}

// K2 at one form: resident (HeadShape) where head_resident, else
// streamed.
template <int PLANES, int CIN, int R>
cudaError_t k2_form(const void* x, const void* w, const float* b,
                    const uint8_t* orig, uint8_t* out, int B, int H, int W,
                    cudaStream_t s) {
  if constexpr (head_resident<PLANES, CIN, R>())
    return launch_res<PLANES, CIN, HeadShape<PLANES, CIN, R>, R>(
        x, w, b, nullptr, out, nullptr, B, H, W, s, orig);
  else
    return launch<PLANES, CIN, R>(x, w, b, nullptr, orig, out, B, H, W, s);
}

template <int PLANES, int CIN>
cudaError_t k2_at(const void* x, const void* w, const float* b,
                  const uint8_t* orig, uint8_t* out, int B, int H, int W,
                  int r, cudaStream_t s) {
  switch (r) {
    case 2: return k2_form<PLANES, CIN, 2>(x, w, b, orig, out, B, H, W, s);
    case 3: return k2_form<PLANES, CIN, 3>(x, w, b, orig, out, B, H, W, s);
    case 4: return k2_form<PLANES, CIN, 4>(x, w, b, orig, out, B, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

// K2 at `feat` (32, 96, 128) input channels and scale r (2, 3, 4).
template <int PLANES>
cudaError_t k2(const void* x, const void* w, const float* b,
               const uint8_t* orig, uint8_t* out, int B, int H, int W,
               int feat, int r, cudaStream_t s) {
  switch (feat) {
    case 32: return k2_at<PLANES, 32>(x, w, b, orig, out, B, H, W, r, s);
    case 96: return k2_at<PLANES, 96>(x, w, b, orig, out, B, H, W, r, s);
    case 128: return k2_at<PLANES, 128>(x, w, b, orig, out, B, H, W, r, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wide
}  // namespace reve
