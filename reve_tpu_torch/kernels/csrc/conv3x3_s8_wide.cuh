// K4 conv3x3_s8_dq_prelu_q8 and K4h head_conv_s8_residual_u8_shuffle of
// an int8 SRVGG of 32, 96 or 128 features on s8 wgmma: one template,
// instantiated by conv3x3_s8.cu behind its *_wide entry points.  The
// 64-feature forms are that source's own kernels, unchanged.
//
// Replaces (TPU side) what conv3x3_s8.cu's kernels replace, at the SRVGG's
// num_feat F: the classic-domain loop of reve_tpu/models/srvgg.py
// apply_int8 over F -> F (srvgg.py:380-382: _conv3x3_s8 :268-276, dq_prelu
// :322-329, _quant_s8 :279-288) and its int8 head F -> 3r^2 (:383-386 with
// _epilogue :239-262 and reve_tpu/ops/pixel_shuffle.py:14-22).  What they
// compute and where they round is the 64-feature kernels' (K4: float32(acc)
// * scale + b, PReLU, reve::quant_s8, each step rounded on its own; K4h:
// float32(acc) * scale + b, then tc.cuh's HeadEpilogue).  At 128 features
// |acc| may pass 2^24 (9 x 128 x 127^2 < 2^24.2): its float32 conversion
// rounds to nearest even there, as torch's and XLA's int32 -> float32
// casts do.
//
// Bound on an H100 SXM (1979 TOP/s s8 dense, 3.35 TB/s) per call of 4
// 1080p frames (P = 8.29 M pixels): K4 at F = 32 2 P F B in + out ->
// 0.158 ms (bytes), at 96 2 x 9 F^2 P = 1,376 GOP -> 0.695 ms and at 128
// 2,446 GOP -> 1.236 ms (operations); K4h at r = 4 P (F + 3 + 48) B ->
// 0.206 and 0.364 ms at 32 and 96 (bytes), 917 GOP -> 0.464 ms at 128
// (operations).
//
// Design: conv3x3_wide.cuh's, in s8.  Resident s8 weights are 9 F^2 B (147
// KB at 128), and two slots of the whole Cin's halo 68 KB at 128: both
// and the staged outputs pass a block's 227 KB.  So the halo streams in
// units of 32 input channels, and the weights stay resident:
//  * A unit's halo ((TH+2) x 66 pixels, one 32-B row a pixel: a TMA box of
//    32 channels at channel 32u of a tensor map over the whole pixel, in
//    the 32-B swizzle wgmma reads) goes to one of two slots (13 KB each).
//    A tap's A is the halo started dy * 66 + dx whole 32-B rows later,
//    one k32 step (m64nNk32, s32 accumulators in registers): 9 wgmmas a
//    unit.
//  * The weights ([unit][tap][k / 16][n][16] s8, K-major core matrices of
//    8 rows x 16 B; packed by the wrapper, kernels/conv3x3_s8.py
//    pack_weights_s8_wide) are copied once a block and stay resident: 147
//    KB for K4 at 128 beside the two halo slots and the staged outputs
//    (213 KB).  Streamed unit by unit with each unit's halo instead (36
//    KB a unit, 147 KB from L2 a 256-pixel tile), K4 at 128 took 2.24 ms
//    a call of 4 1080p frames against 2.09 resident (H100 SXM).
//  * One thread of a producer warpgroup issues every copy and waits for
//    the slot it refills to be released; four consumer warpgroups (one
//    output row of 64 pixels each, M = 64, N = Cout padded to a multiple
//    of 8) issue a unit's nine wgmmas as one group and release the unit
//    before it once that group is retired (wgmma_wait<1>), so consecutive
//    units' wgmmas overlap.  The producer gives its registers to the
//    consumers by setmaxnreg (112 a thread), as conv3x3_wide.cuh's does.
//  * The epilogues read the channels' scale, bias and alpha from shared
//    memory (at N 128 a thread's share would take 96 registers).  K4
//    stages its row's 64 x N s8 codes at a pitch of N + 16 bytes (the 8
//    pixel rows a warp writes at once fall on distinct banks) and writes
//    them as 16-B vectors, one contiguous run of 64 N bytes a row; K4h is
//    tc.cuh's HeadEpilogue.
#pragma once

#include "tc.cuh"

namespace reve {
namespace s8wide {

using namespace reve::tc;

constexpr int TW = 64;  // tile columns: the M of one wgmma
constexpr int CK = 32;  // input channels of a unit: one 32-B halo row

// CIN: the SRVGG's num_feat; R = 0: K4 (dequant + PReLU + requant, Cout =
// CIN), R = 2, 3, 4: K4h (u8 residual + pixel shuffle at scale R).
template <int CIN, int R>
struct S8Wide {
  using Epi = HeadEpilogue<R>;  // K4h's; unused by K4
  static constexpr int COUT = R == 0 ? CIN : 3 * R * R;
  static constexpr int N = (COUT + 7) / 8 * 8;
  static constexpr int TH = 4;
  static constexpr int THREADS = 128 * (TH + 1);  // + the producer
  // registers a thread: __launch_bounds__(THREADS, 1) caps each at 96, and
  // launch() refuses a kernel that ptxas gave any other count; the
  // producer hands most of its own to the consumers (setmaxnreg.inc waits
  // until the block's own registers cover it)
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS =
      ((TH + 1) * LAUNCH_REGS - PRODUCER_REGS) / TH / 8 * 8;
  static constexpr int UNITS = CIN / CK;
  static constexpr int HALO_TX = (TH + 2) * (TW + 2) * CK;  // bytes
  static constexpr int HALO_BYTES = (HALO_TX + 1023) / 1024 * 1024;
  static constexpr int UNIT_W = 9 * CK * N;  // a unit's weights, bytes
  static constexpr int TAP_W = CK * N;       // a tap's, one k32 step
  static constexpr int SLOTS = 2;
  // K4's staged codes of a row: 64 pixels at a pitch of N + 16 bytes
  static constexpr int PITCH = N + 16;
  static constexpr int STAGE = R == 0 ? TW * PITCH : Epi::STAGE;
  static constexpr int ORIG = R == 0 ? 0 : Epi::ORIG;
  static constexpr size_t OFF_W = (size_t)SLOTS * HALO_BYTES;
  static constexpr size_t OFF_STAGE = OFF_W + (size_t)UNITS * UNIT_W;
  static constexpr size_t OFF_ORIG = OFF_STAGE + TH * STAGE;
  static constexpr size_t OFF_PAR = (OFF_ORIG + TH * ORIG + 15) / 16 * 16;
  static constexpr size_t OFF_BAR =
      OFF_PAR + 3 * N * sizeof(float);  // scale, b, alpha
  // barriers: SLOTS full, SLOTS empty, the weights' full
  static constexpr size_t SMEM = OFF_BAR + (2 * SLOTS + 1) * sizeof(uint64_t);
  static_assert(CIN % CK == 0, "Cin in whole units of 32 channels");
  static_assert(SLOTS == 2, "slots by masks");
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
  static_assert(OFF_STAGE % 16 == 0 && STAGE % 16 == 0 && OFF_BAR % 8 == 0,
                "16-B staging and 8-B barriers");
  static_assert(CONSUMER_REGS <= 256 &&
                    PRODUCER_REGS + TH * CONSUMER_REGS <=
                        (TH + 1) * LAUNCH_REGS,
                "more registers than the block was launched with");
};

// `map`: the s8 input's tensor map (32-channel boxes); `w`: the packed
// weights, [unit][tap][k / 16][n][16] s8; `scale`, `bias` (and K4's
// `alpha`): COUT float32 each; `inv_next`: K4's float32(1 / act_scale[i +
// 1]); `orig`: K4h's u8 input frames.
template <int CIN, int R>
__global__ void __launch_bounds__(S8Wide<CIN, R>::THREADS, 1)
conv3x3_s8_wide_kernel(const __grid_constant__ CUtensorMap map,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const float* __restrict__ alpha,
                       const float* __restrict__ inv_next,
                       const uint8_t* __restrict__ orig,
                       void* __restrict__ out, int B, int H, int W) {
  using K = S8Wide<CIN, R>;
  using Epi = typename K::Epi;
  constexpr int N = K::N, COUT = K::COUT, TH = K::TH, UNITS = K::UNITS;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;  // warpgroup = tile row

  float* ss = reinterpret_cast<float*>(smem + K::OFF_PAR);
  float* bs = ss + N;
  float* as = bs + N;
  for (int i = tid; i < N; i += K::THREADS) {
    ss[i] = i < COUT ? scale[i] : 0.f;
    bs[i] = i < COUT ? bias[i] : 0.f;
    as[i] = R == 0 ? alpha[i] : 0.f;
  }
  const uint32_t h_full = base + (uint32_t)K::OFF_BAR;
  const uint32_t h_empty = h_full + 8 * K::SLOTS;
  const uint32_t w_full = h_empty + 8 * K::SLOTS;
  if (tid == 0) {
    for (int s = 0; s < K::SLOTS; ++s) {
      mbar_init(h_full + 8 * s, 1);
      mbar_init(h_empty + 8 * s, TH);
    }
    mbar_init(w_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const TileGrid<TH, TW> g(B, H, W);

  if (wg == TH) {
    // The producer: one thread issues every copy.  The weights first;
    // then unit hu (the block's hu-th) goes to slot hu % SLOTS once the
    // warpgroups released unit hu - SLOTS.
    setmaxnreg_dec<K::PRODUCER_REGS>();
    if (t != 0) return;
    mbar_expect_tx(w_full, UNITS * K::UNIT_W);
    bulk_load(base + (uint32_t)K::OFF_W, w, UNITS * K::UNIT_W, w_full);
    uint32_t hu = 0;
    for (long long tile = blockIdx.x; tile < g.count; tile += gridDim.x) {
      int b, y0, x0;
      g.origin(tile, b, y0, x0);
      for (int u = 0; u < UNITS; ++u, ++hu) {
        const uint32_t hs = hu & 1;
        if (hu >= K::SLOTS)
          mbar_wait(h_empty + 8 * hs, ((hu >> 1) - 1) & 1);
        mbar_expect_tx(h_full + 8 * hs, K::HALO_TX);
        tma_load_4d(base + hs * K::HALO_BYTES, &map, h_full + 8 * hs,
                    u * CK, x0 - 1, y0 - 1, b);
      }
    }
    return;
  }

  // The warpgroups: a unit's nine taps one wgmma group, each release a
  // predicated arrival after the wait that retires the unit.
  setmaxnreg_inc<K::CONSUMER_REGS>();
  const int lane = t & 31;
  const int p0 = (t >> 5) * 16 + (lane >> 2), c0 = (lane & 3) * 2;
  const float inv = R == 0 ? *inv_next : 0.f;
  unsigned char* st = smem + K::OFF_STAGE + wg * K::STAGE;
  mbar_wait(w_full, 0);
  uint32_t hu = 0;  // the block's units before this one
  for (long long tile = blockIdx.x; tile < g.count; tile += gridDim.x) {
    int b, y0, x0;
    g.origin(tile, b, y0, x0);
    const int oy = y0 + wg;
    const int valid = min(TW, W - x0);  // pixels of this row in the frame
    // K4h reads the row's u8 input pixels before the wgmmas; the loads
    // land while the tensor cores work
    uint8_t o0 = 0, o1 = 0;
    if constexpr (R > 0)
      Epi::load_orig(orig, b, oy, x0, H, W, valid, t, o0, o1);
    int acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0;
#pragma unroll 1
    for (int u = 0; u < UNITS; ++u, ++hu) {
      const uint32_t hs = hu & 1;
      mbar_wait(h_full + 8 * hs, (hu >> 1) & 1);
      const uint32_t a_row = base + hs * K::HALO_BYTES + wg * (TW + 2) * CK;
      const uint32_t wu = base + (uint32_t)(K::OFF_W + u * K::UNIT_W);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        WgmmaS8<N>::mma(
            acc,
            desc_sw32(a_row + ((tap / 3) * (TW + 2) + tap % 3) * CK),
            desc(wu + tap * K::TAP_W, N * 16));
      wgmma_commit();
      fence_regs(acc);
      // the unit before this one is done: release its slot
      wgmma_wait<1>();
      mbar_arrive_if(h_empty + 8 * ((hu - 1) & 1), t == 0 && u > 0);
    }
    // the tile's last unit, and its slot
    wgmma_wait<0>();
    mbar_arrive_if(h_empty + 8 * ((hu - 1) & 1), t == 0);
    fence_regs(acc);

    // accumulator fragment: register 4j + 2h + e holds pixel
    // 16 * warp + lane / 4 + 8h, channel 8j + 2 * (lane % 4) + e
    if constexpr (R == 0) {
      warpgroup_sync(wg);  // the last tile's staged codes are written out
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int c = 8 * j + c0;
        const float2 sc = *reinterpret_cast<const float2*>(ss + c);
        const float2 bi = *reinterpret_cast<const float2*>(bs + c);
        const float2 al = *reinterpret_cast<const float2*>(as + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 4 * j + 2 * h;
          const float f0 =
              __fadd_rn(__fmul_rn((float)acc[q], sc.x), bi.x);
          const float f1 =
              __fadd_rn(__fmul_rn((float)acc[q + 1], sc.y), bi.y);
          const float v0 = f0 > 0.f ? f0 : __fmul_rn(al.x, f0);
          const float v1 = f1 > 0.f ? f1 : __fmul_rn(al.y, f1);
          *reinterpret_cast<uint16_t*>(st + (p0 + 8 * h) * K::PITCH + c) =
              (uint16_t)(reve::quant_s8(v0, inv) |
                         reve::quant_s8(v1, inv) << 8);
        }
      }
      warpgroup_sync(wg);
      if (oy < H) {
        int8_t* yr = static_cast<int8_t*>(out) +
                     (((long long)b * H + oy) * W + x0) * N;
        for (int q = t; q < TW * (N / 16); q += 128) {
          const int p = q / (N / 16), ch = q - p * (N / 16);
          if (p < valid)
            *reinterpret_cast<uint4*>(yr + (long long)p * N + ch * 16) =
                *reinterpret_cast<const uint4*>(st + p * K::PITCH + ch * 16);
        }
      }
    } else {
      // float32(acc) * scale + b in float32, with no cast to the compute
      // dtype, then the residual
      Epi::template row<N>(
          st, smem + K::OFF_ORIG + wg * K::ORIG, static_cast<uint8_t*>(out),
          b, oy, x0, H, W, valid, wg, t, o0, o1, [&](int q, int kk) {
            return __fadd_rn(__fmul_rn((float)acc[q], ss[kk]), bs[kk]);
          });
    }
  }
}

template <int CIN, int R>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* bias, const float* alpha,
                   const float* inv_next, const uint8_t* orig, void* out,
                   int B, int H, int W, cudaStream_t stream) {
  using K = S8Wide<CIN, R>;
  const long long tiles =
      (long long)B * ((H + K::TH - 1) / K::TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  CUtensorMap map;
  cudaError_t err = halo_map(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, B, H,
                             W, TW + 2, K::TH + 2, CU_TENSOR_MAP_SWIZZLE_32B,
                             CK, CIN);
  if (err != cudaSuccess) return err;
  auto kernel = conv3x3_s8_wide_kernel<CIN, R>;
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
      map, static_cast<const int8_t*>(w), scale, bias, alpha, inv_next, orig,
      out, B, H, W);
  return cudaGetLastError();
}

// K4 at `feat` (32, 96, 128) input and output channels.
inline cudaError_t k4(const void* x, const void* w, const float* scale,
                      const float* bias, const float* alpha,
                      const float* inv_next, void* y, int B, int H, int W,
                      int feat, cudaStream_t s) {
  switch (feat) {
    case 32: return launch<32, 0>(x, w, scale, bias, alpha, inv_next,
                                  nullptr, y, B, H, W, s);
    case 96: return launch<96, 0>(x, w, scale, bias, alpha, inv_next,
                                  nullptr, y, B, H, W, s);
    case 128: return launch<128, 0>(x, w, scale, bias, alpha, inv_next,
                                    nullptr, y, B, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int CIN>
cudaError_t k4h_at(const void* x, const void* w, const float* scale,
                   const float* b, const uint8_t* orig, uint8_t* out, int B,
                   int H, int W, int r, cudaStream_t s) {
  switch (r) {
    case 2: return launch<CIN, 2>(x, w, scale, b, nullptr, nullptr, orig,
                                  out, B, H, W, s);
    case 3: return launch<CIN, 3>(x, w, scale, b, nullptr, nullptr, orig,
                                  out, B, H, W, s);
    case 4: return launch<CIN, 4>(x, w, scale, b, nullptr, nullptr, orig,
                                  out, B, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

// K4h at `feat` (32, 96, 128) input channels and scale r (2, 3, 4).
inline cudaError_t k4h(const void* x, const void* w, const float* scale,
                       const float* b, const uint8_t* orig, uint8_t* out,
                       int B, int H, int W, int feat, int r,
                       cudaStream_t s) {
  switch (feat) {
    case 32: return k4h_at<32>(x, w, scale, b, orig, out, B, H, W, r, s);
    case 96: return k4h_at<96>(x, w, scale, b, orig, out, B, H, W, r, s);
    case 128: return k4h_at<128>(x, w, scale, b, orig, out, B, H, W, r, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace s8wide
}  // namespace reve
