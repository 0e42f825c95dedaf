// K1 conv3x3_bias_prelu and K2 head_conv_residual_u8_shuffle of an SRVGG
// of 32, 96 or 128 features, in both compute dtypes, on the tensor cores:
// one template, instantiated by conv3x3_tc.cu in bfloat16 (PLANES 1) and
// by conv3x3_f32_tc.cu in float32 (PLANES 3, the split pass's planes,
// six bf16 products).  The 64-feature forms are those sources' own
// kernels, unchanged.
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
// 14.84 ms; bf16 K2 at r = 4 0.232, 0.696 and 0.927 ms (operations).
//
// Design.  What breaks the 64-feature kernels' design at these widths is
// shared memory (227 KB a block): bf16 K1 keeps all nine taps of weights
// resident (294,912 B at 128) beside two halos of the whole Cin (204,800
// B at 128), float32 K1 three planes of the whole Cin's halo.  So here
// both the halo and the weights stream in units of 32 input channels:
//  * A unit is 32 channels of Cin: its halo ((TH+2) x 66 pixels, one 64-B
//    row a pixel, in the 64-B swizzle wgmma reads, a TMA box of 32
//    channels at channel 32u of a tensor map over the whole pixel; three
//    boxes, one a plane, in float32) goes to one of two slots, and its
//    nine taps' weights ([split][k / 8][n][8], K-major, 32 k: packed by
//    the wrapper, kernels/conv3x3.py pack_weights_wide) stream through a
//    ring of four stages by bulk copies.  A tap's A is the halo started
//    whole 64-B rows later (dy * 66 + dx), as in conv3x3_s8.cu's 64-B
//    rows; its two k16 steps are 32 B apart in a row.
//  * One thread of a producer warpgroup issues every copy in the order
//    the warpgroups consume them and waits for the slot or stage it
//    refills to be released; the warpgroups (one output row of 64 pixels
//    each, M = 64, N = Cout padded to a multiple of 8) run no branch on the
//    thread index between a wgmma and its wait: each tap's release is a
//    predicated arrival after the wait that retires the tap before it, so
//    consecutive taps' wgmmas overlap.  The producer warpgroup gives its
//    registers to the consumers by setmaxnreg (112 a thread at TH 4, 240
//    at TH 2), as rrdb.cu's does.
//  * Tiles of TH = 4 rows (four warpgroups), or 2 in float32 at N 96 and
//    128, whose two accumulator sets (hi.hi apart from the five smaller
//    products, as conv3x3_f32_tc.cu keeps them) take 96 and 128
//    registers a thread.
//  * K1's epilogue writes straight from the accumulator fragment (bf16
//    pairs, float32 pairs), K2's is tc.cuh's HeadEpilogue.
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

// `x`: the input's tensor map (B images, or the three planes' 3B);
// `w`: the packed weights, [unit][tap][split][k / 8][n][8] bf16.
template <int PLANES, int CIN, int R>
__global__ void __launch_bounds__(Wide<PLANES, CIN, R>::THREADS, 1)
conv3x3_wide_kernel(const __grid_constant__ CUtensorMap map,
                    const bf16* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ alpha,
                    const uint8_t* __restrict__ orig,
                    void* __restrict__ out, int B, int H, int W) {
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
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < CK / 16; ++kc)
          mma_step<K>(acc, cor, a + kc * 32, ws + 2 * kc * N * 16);
        wgmma_commit();
        fence_acc<K>(acc, cor);
        // the tap before this one is done: release its stage (none
        // before the tile's first), and at a unit's first tap the last
        // unit's halo slot
        wgmma_wait<1>();
        mbar_arrive_if(w_empty + 8 * ((gi - 1) & 3),
                       t == 0 && (tap > 0 || u > 0));
        if (tap == 0)
          mbar_arrive_if(h_empty + 8 * ((hu - 1) & 1), t == 0 && u > 0);
      }
    }
    // the tile's last tap, and its last unit's halo slot
    wgmma_wait<0>();
    mbar_arrive_if(w_empty + 8 * ((gi - 1) & 3), t == 0);
    mbar_arrive_if(h_empty + 8 * ((hu - 1) & 1), t == 0);
    fence_acc<K>(acc, cor);

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
              *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
                  make_float2(v0, v1);
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
                   int H, int W, cudaStream_t stream) {
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
      map, static_cast<const bf16*>(w), b, alpha, orig, out, B, H, W);
  return cudaGetLastError();
}

// K1 at `feat` (32, 96, 128) input and output channels.
template <int PLANES>
cudaError_t k1(const void* x, const void* w, const float* b,
               const float* alpha, void* y, int B, int H, int W, int feat,
               cudaStream_t s) {
  switch (feat) {
    case 32: return launch<PLANES, 32, 0>(x, w, b, alpha, nullptr, y, B, H,
                                          W, s);
    case 96: return launch<PLANES, 96, 0>(x, w, b, alpha, nullptr, y, B, H,
                                          W, s);
    case 128: return launch<PLANES, 128, 0>(x, w, b, alpha, nullptr, y, B,
                                            H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int PLANES, int CIN>
cudaError_t k2_at(const void* x, const void* w, const float* b,
                  const uint8_t* orig, uint8_t* out, int B, int H, int W,
                  int r, cudaStream_t s) {
  switch (r) {
    case 2: return launch<PLANES, CIN, 2>(x, w, b, nullptr, orig, out, B, H,
                                          W, s);
    case 3: return launch<PLANES, CIN, 3>(x, w, b, nullptr, orig, out, B, H,
                                          W, s);
    case 4: return launch<PLANES, CIN, 4>(x, w, b, nullptr, orig, out, B, H,
                                          W, s);
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
