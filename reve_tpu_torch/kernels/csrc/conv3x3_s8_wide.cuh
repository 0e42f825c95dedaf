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
// Design: the halo streams in units of 32 input channels and the weights
// stay resident (9 F^2 B, 147 KB for K4 at 128: the whole Cin's halo in
// two slots would not fit beside them):
//  * A unit's halo ((TH+2) x 66 pixels, one 32-B row a pixel: a TMA box of
//    32 channels at channel 32u of a tensor map over the whole pixel, in
//    the 32-B swizzle wgmma reads) goes to one of HS slots.  A tap's A is
//    the halo started dy * 66 + dx whole 32-B rows later, one k32 step
//    (m64nNk32, s32 accumulators in registers): 9 wgmmas a unit and row.
//  * The weights ([unit][tap][k / 16][n][16] s8, K-major core matrices of
//    8 rows x 16 B; packed by the wrapper once per set of weights,
//    kernels/conv3x3_s8.py packed_s8_wide) come in by one bulk copy a
//    block and stay.  (Streamed unit by unit with each unit's halo, 147 KB
//    from L2 a 256-pixel tile, K4 at 128 took 2.24 ms a call of 4 1080p
//    frames against 2.09 resident, H100 SXM.)
//  * Consumer teams (`S8Shape`: TEAMS teams of TEAM_WGS warpgroups of RPW
//    rows, tiles of TEAM_WGS x RPW rows) take the block's tiles in turn,
//    as rrdb_s8.cu's and conv3x3_wide.cuh's resident kernel's do: a team
//    issues a tile's wgmmas only after the team before it has issued its
//    own (`turn`), so the halo units are read in the order the producer
//    loads them, and the other teams' epilogues run beside a team's
//    wgmmas.  A warpgroup's RPW rows are innermost in a tap, so each
//    step's B descriptor serves them.  (With every warpgroup on one tile,
//    this kernel's first design, no epilogue overlapped a wgmma.)
//  * One thread of a producer warpgroup issues the weights' copy and every
//    halo unit into a ring of HS slots, each once the team that read the
//    unit HS before it released it; a team issues a unit's wgmmas as one
//    group and releases the unit before it once that group is retired
//    (wgmma_wait<1>), with a predicated arrival: no branch on the thread
//    index between a wgmma and its wait.  setmaxnreg hands the producer's
//    registers to the teams (ptxas still holds each consumer to the
//    launch bound, 65,536 / THREADS: launch() refuses another count).
//  * The epilogues: K4h tc.cuh's HeadEpilogue, a row at a time; K4 stages
//    its rows' 64 x N s8 codes box by box (32 channels) in the 32-B
//    swizzle, conflict-free, and one thread writes them by TMA stores
//    (faster than the threads' 16-B stores at 32 and 128).  A thread
//    keeps its channels' parameters in registers (K4 at 32, K4h; K4 at
//    96 and 128 reads them from shared memory: 48 and 64 accumulator
//    registers a row leave no room), and K4 quantizes in float32
//    arithmetic (common.cuh's quant_bits): the conversion instructions
//    issue at a quarter of the float32 rate.  At 32 features the epilogue, not the
//    wgmmas, set the first design's pace (perf_conv_tc_parts: its
//    `no_epi` 0.20 of 0.37 ms a call).
#pragma once

#include "tc.cuh"

namespace reve {
namespace s8wide {

using namespace reve::tc;

constexpr int TW = 64;  // tile columns: the M of one wgmma
constexpr int CK = 32;  // input channels of a unit: one 32-B halo row

// A form's shape: TEAMS teams of TEAM_WGS consumer warpgroups of RPW rows
// each, HS halo slots; one block on each SM.
template <int TEAMS_, int TEAM_WGS_, int RPW_, int HS_>
struct Shape {
  static constexpr int TEAMS = TEAMS_, TEAM_WGS = TEAM_WGS_, RPW = RPW_,
                       HS = HS_;
};

// The shape of each form (K4 at R = 0, K4h at R = 2, 3, 4), the fastest
// of those tried on an H100 SXM (perf_conv_tc_parts --sources
// conv3x3_s8_wide.cuh, its shape variants; PERF.md section 6): K4h two
// teams of two warpgroups of two rows (4-row tiles, the halo read 1.5x),
// 4 slots; K4 at 32, where the epilogue and the bytes set the pace, two
// teams of one warpgroup of eight rows (8-row tiles, the halo read
// 1.25x; 168 registers a thread at 384 threads), 6 slots; K4 at 96 and
// 128 (48 and 64 accumulator registers a row) two teams of two
// warpgroups of one row, 4 and 3 slots beside the weights.  Several
// blocks on each SM (the 64-feature K4's route, a block one team) were
// slower at 32.
template <int CIN, int R>
struct S8Shape : Shape<2, 2, 2, 4> {};
template <>
struct S8Shape<32, 0> : Shape<2, 1, 8, 6> {};
template <>
struct S8Shape<96, 0> : Shape<2, 2, 1, 4> {};
template <>
struct S8Shape<128, 0> : Shape<2, 2, 1, 3> {};

// CIN: the SRVGG's num_feat; R = 0: K4 (dequant + PReLU + requant, Cout =
// CIN), R = 2, 3, 4: K4h (u8 residual + pixel shuffle at scale R).
template <int CIN, int R, class S>
struct S8Wide {
  using Epi = HeadEpilogue<R>;  // K4h's; unused by K4
  static constexpr int COUT = R == 0 ? CIN : 3 * R * R;
  static constexpr int N = (COUT + 7) / 8 * 8;
  static constexpr int TEAMS = S::TEAMS, TEAM_WGS = S::TEAM_WGS,
                       RPW = S::RPW, HS = S::HS;
  static constexpr int WGS = TEAMS * TEAM_WGS;
  static constexpr int TH = TEAM_WGS * RPW;        // tile rows
  static constexpr int THREADS = 128 * (WGS + 1);  // + the producer
  // registers a thread: __launch_bounds__(THREADS, 1) caps each at
  // LAUNCH_REGS, and launch() refuses a kernel that ptxas gave any other
  // count; the producer hands most of its own to the consumers
  // (setmaxnreg.inc waits until the block's own registers cover it, so a
  // budget the block does not hold would hang the card)
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int SPARE =
      ((WGS + 1) * LAUNCH_REGS - PRODUCER_REGS) / WGS / 8 * 8;
  static constexpr int CONSUMER_REGS = SPARE > 256 ? 256 : SPARE;
  static constexpr int UNITS = CIN / CK;
  static constexpr int HALO_TX = (TH + 2) * (TW + 2) * CK;  // bytes
  static constexpr int HALO_BYTES = (HALO_TX + 1023) / 1024 * 1024;
  static constexpr int TAP_W = CK * N;        // a tap's weights, one k32 step
  static constexpr int UNIT_W = 9 * TAP_W;    // a unit's
  static constexpr int W_BYTES = UNITS * UNIT_W;
  // K4's staged codes of a warpgroup's RPW rows (boxes of 32 channels x
  // 64 pixels x RPW rows in their 32-B swizzle, written by TMA stores);
  // K4h's one row's R output rows
  static constexpr int STAGE = R == 0 ? RPW * TW * N : Epi::STAGE;
  static constexpr int ORIG = R == 0 ? 0 : Epi::ORIG;
  static constexpr size_t OFF_W = (size_t)HS * HALO_BYTES;
  static constexpr size_t OFF_STAGE =
      (OFF_W + (size_t)W_BYTES + 1023) / 1024 * 1024;
  static constexpr size_t OFF_ORIG = OFF_STAGE + (size_t)WGS * STAGE;
  static constexpr size_t OFF_PAR = (OFF_ORIG + WGS * ORIG + 15) / 16 * 16;
  static constexpr size_t OFF_BAR =
      OFF_PAR + 3 * N * sizeof(float);  // scale, b, alpha
  // barriers: HS full, HS empty, the weights', a team's turn each
  static constexpr size_t SMEM =
      OFF_BAR + (2 * HS + 1 + TEAMS) * sizeof(uint64_t);
  static_assert(CIN % CK == 0, "Cin in whole units of 32 channels");
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
  static_assert(THREADS <= 1024 && WGS < 16,
                "a block's threads, a named barrier per warpgroup");
  static_assert(OFF_STAGE % 16 == 0 && STAGE % 16 == 0 && OFF_BAR % 8 == 0,
                "16-B staging and 8-B barriers");
  static_assert(PRODUCER_REGS + WGS * CONSUMER_REGS <=
                    (WGS + 1) * LAUNCH_REGS,
                "more registers than the block was launched with");
};

// `map`: the s8 input's tensor map (32-channel boxes); `out_map`: K4's
// output's (32-channel boxes of its RPW rows; K4h: unused); `w`: the packed
// weights, [unit][tap][k / 16][n][16] s8; `scale`, `bias` (and K4's
// `alpha`): COUT float32 each; `inv_next`: K4's float32(1 / act_scale[i +
// 1]); `orig`: K4h's u8 input frames.
template <int CIN, int R, class S>
__global__ void __launch_bounds__(S8Wide<CIN, R, S>::THREADS, 1)
conv3x3_s8_wide_kernel(const __grid_constant__ CUtensorMap map,
                       const __grid_constant__ CUtensorMap out_map,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const float* __restrict__ alpha,
                       const float* __restrict__ inv_next,
                       const uint8_t* __restrict__ orig,
                       void* __restrict__ out, int B, int H, int W) {
  using K = S8Wide<CIN, R, S>;
  using Epi = typename K::Epi;
  constexpr int N = K::N, COUT = K::COUT, UNITS = K::UNITS, HS = K::HS;
  constexpr int WGS = K::WGS, TEAMS = K::TEAMS, TEAM_WGS = K::TEAM_WGS,
                RPW = K::RPW;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;

  float* ss = reinterpret_cast<float*>(smem + K::OFF_PAR);
  float* bs = ss + N;
  float* as = bs + N;
  for (int i = tid; i < N; i += K::THREADS) {
    ss[i] = i < COUT ? scale[i] : 0.f;
    bs[i] = i < COUT ? bias[i] : 0.f;
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
    for (int m = 0; m < TEAMS; ++m) mbar_init(turn + 8 * m, TEAM_WGS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const TileGrid<K::TH, TW> g(B, H, W);

  if (wg == WGS) {
    // The producer: one thread issues the weights' copy, then every halo
    // unit in the order the teams read them: the block's hu-th unit (unit
    // hu % UNITS of its tile hu / UNITS) goes to slot hu % HS once the team
    // that read unit hu - HS released it.
    setmaxnreg_dec<K::PRODUCER_REGS>();
    if (t != 0) return;
    mbar_expect_tx(w_full, K::W_BYTES);
    bulk_load(base + (uint32_t)K::OFF_W, w, K::W_BYTES, w_full);
    uint32_t hu = 0;
    for (long long tile = blockIdx.x; tile < g.count; tile += gridDim.x) {
      int b, y0, x0;
      g.origin(tile, b, y0, x0);
      for (int u = 0; u < UNITS; ++u, ++hu) {
        const uint32_t hs = hu % HS;
        if (hu >= HS) mbar_wait(h_empty + 8 * hs, (hu / HS - 1) & 1);
        mbar_expect_tx(h_full + 8 * hs, K::HALO_TX);
        tma_load_4d(base + hs * K::HALO_BYTES, &map, h_full + 8 * hs,
                    u * CK, x0 - 1, y0 - 1, b);
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
  const float inv = R == 0 ? *inv_next : 0.f;
  unsigned char* st = smem + K::OFF_STAGE + wg * K::STAGE;
  // this thread's channels' parameters (8jj + c0 + {0, 1}) in registers,
  // read once: K4's scale, b and alpha at N <= 32, K4h's scale and b (N
  // <= 48); K4 at 96 and 128 reads them from shared memory
  constexpr int PJ = R > 0 || N <= 32 ? N / 8 : 1;
  float2 psc[PJ], pbi[PJ], pal[R == 0 ? PJ : 1];
  if constexpr (PJ > 1)
#pragma unroll
    for (int jj = 0; jj < PJ; ++jj) {
      psc[jj] = *reinterpret_cast<const float2*>(ss + 8 * jj + c0);
      pbi[jj] = *reinterpret_cast<const float2*>(bs + 8 * jj + c0);
      if constexpr (R == 0)
        pal[jj] = *reinterpret_cast<const float2*>(as + 8 * jj + c0);
    }
  mbar_wait(w_full, 0);
  int j = 0;  // the team's tiles so far
  for (long long tile = blockIdx.x + (long long)team * gridDim.x;
       tile < g.count; tile += (long long)TEAMS * gridDim.x, ++j) {
    const long long kk = (long long)TEAMS * j + team;  // the block's tile
    int b, y0, x0;
    g.origin(tile, b, y0, x0);
    const int valid = min(TW, W - x0);  // pixels of a row in the frame
    // K4h reads its rows' u8 input pixels first; the loads land while the
    // team waits for its turn and the tensor cores work
    uint8_t o0[RPW], o1[RPW];
    if constexpr (R > 0)
#pragma unroll
      for (int s = 0; s < RPW; ++s)
        Epi::load_orig(orig, b, y0 + r0 + s, x0, H, W, valid, t, o0[s],
                       o1[s]);
    // the team before has issued its wgmmas of the block's tile kk - 1
    if (TEAMS > 1 && kk > 0)
      mbar_wait(turn + 8 * team, (uint32_t)((j - (team == 0)) & 1));
    int acc[RPW][N / 2];
#pragma unroll
    for (int s = 0; s < RPW; ++s)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[s][i] = 0;
    uint32_t hu = (uint32_t)kk * UNITS;  // the block's units before this
#pragma unroll 1
    for (int u = 0; u < UNITS; ++u, ++hu) {
      const uint32_t hs = hu % HS;
      mbar_wait(h_full + 8 * hs, (hu / HS) & 1);
      const uint32_t a_rows =
          base + hs * K::HALO_BYTES + r0 * (TW + 2) * CK;
      const uint32_t wu = base + (uint32_t)(K::OFF_W + u * K::UNIT_W);
#pragma unroll
      for (int s = 0; s < RPW; ++s) fence_regs(acc[s]);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int s = 0; s < RPW; ++s)
          WgmmaS8<N>::mma(
              acc[s],
              desc_sw32(a_rows +
                        ((s + tap / 3) * (TW + 2) + tap % 3) * CK),
              desc(wu + tap * K::TAP_W, N * 16));
      wgmma_commit();
#pragma unroll
      for (int s = 0; s < RPW; ++s) fence_regs(acc[s]);
      // the unit before this one is done: release its slot
      wgmma_wait<1>();
      mbar_arrive_if(h_empty + 8 * ((hu + HS - 1) % HS), t == 0 && u > 0);
    }
    // the next team's turn; then this tile's last wgmmas and its slot
    mbar_arrive_if(turn + 8 * ((team + 1) % TEAMS), TEAMS > 1 && t == 0);
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < RPW; ++s) fence_regs(acc[s]);
    mbar_arrive_if(h_empty + 8 * ((hu - 1) % HS), t == 0);

    // accumulator fragment: register 4j + 2h + e holds pixel
    // 16 * warp + lane / 4 + 8h, channel 8j + 2 * (lane % 4) + e, of row s
    if constexpr (R == 0) {
      // the last tile's staged codes are read by its stores
      if (t == 0) bulk_wait_read<0>();
      warpgroup_sync(wg);
#pragma unroll
      for (int s = 0; s < RPW; ++s)
#pragma unroll
        for (int jj = 0; jj < N / 8; ++jj) {
          const int c = 8 * jj + c0;
          float2 sc, bi, al;
          if constexpr (PJ > 1) {
            sc = psc[jj], bi = pbi[jj], al = pal[jj];
          } else {
            sc = *reinterpret_cast<const float2*>(ss + c);
            bi = *reinterpret_cast<const float2*>(bs + c);
            al = *reinterpret_cast<const float2*>(as + c);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = 4 * jj + 2 * h, p = s * TW + p0 + 8 * h;
            const float f0 =
                __fadd_rn(__fmul_rn((float)acc[s][q], sc.x), bi.x);
            const float f1 =
                __fadd_rn(__fmul_rn((float)acc[s][q + 1], sc.y), bi.y);
            const float v0 = f0 > 0.f ? f0 : __fmul_rn(al.x, f0);
            const float v1 = f1 > 0.f ? f1 : __fmul_rn(al.y, f1);
            // box c / 32 of the RPW rows, its 16-B chunk (c / 16) % 2 of
            // pixel p at chunk (c / 16) % 2 ^ (p / 4) % 2, the 32-B
            // swizzle
            const int at = ((c >> 5) * RPW * TW + p) * 32 +
                           ((c & 31) ^ ((p & 4) << 2));
            *reinterpret_cast<uint16_t*>(st + at) = (uint16_t)__byte_perm(
                quant_bits(v0, inv), quant_bits(v1, inv), 0x40);
          }
        }
      fence_proxy_async();  // the staged codes become visible to TMA
      warpgroup_sync(wg);
      if (t == 0) {
#pragma unroll
        for (int k = 0; k < N / 32; ++k)
          tma_store_4d(&out_map,
                       base + (uint32_t)(st - smem) + k * RPW * TW * 32,
                       32 * k, x0, y0 + r0, b);
        bulk_commit();
      }
    } else {
      // float32(acc) * scale + b in float32, with no cast to the compute
      // dtype, then the residual, a row at a time through the
      // warpgroup's staging area
#pragma unroll
      for (int s = 0; s < RPW; ++s)
        Epi::template row<N>(
            st, smem + K::OFF_ORIG + wg * K::ORIG,
            static_cast<uint8_t*>(out), b, y0 + r0 + s, x0, H, W, valid,
            wg, t, o0[s], o1[s], [&](int q, int c) {
              // register q = 4j + 2h + e: channel c = 8j + c0 + e
              if constexpr (PJ > 1)
                return __fadd_rn(
                    __fmul_rn((float)acc[s][q],
                              q & 1 ? psc[q / 4].y : psc[q / 4].x),
                    q & 1 ? pbi[q / 4].y : pbi[q / 4].x);
              else
                return __fadd_rn(__fmul_rn((float)acc[s][q], ss[c]),
                                 bs[c]);
            });
    }
  }
  // K4's stores have read the staging area before the block leaves it
  if constexpr (R == 0)
    if (t == 0) bulk_wait<0>();
}

template <int CIN, int R>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* bias, const float* alpha,
                   const float* inv_next, const uint8_t* orig, void* out,
                   int B, int H, int W, cudaStream_t stream) {
  using S = S8Shape<CIN, R>;
  using K = S8Wide<CIN, R, S>;
  const long long tiles =
      (long long)B * ((H + K::TH - 1) / K::TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  CUtensorMap map;
  cudaError_t err = halo_map(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, B, H,
                             W, TW + 2, K::TH + 2, CU_TENSOR_MAP_SWIZZLE_32B,
                             CK, CIN);
  if (err != cudaSuccess) return err;
  CUtensorMap out_map = map;  // K4's output; unused by K4h
  if constexpr (R == 0) {
    err = halo_map(&out_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, out, B, H, W,
                   TW, K::RPW, CU_TENSOR_MAP_SWIZZLE_32B, 32, K::N);
    if (err != cudaSuccess) return err;
  }
  auto kernel = conv3x3_s8_wide_kernel<CIN, R, S>;
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
      map, out_map, static_cast<const int8_t*>(w), scale, bias, alpha,
      inv_next, orig, out, B, H, W);
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
