// K7q dense_conv_s8: RRDBNet's dense-block conv in the int8 trunk, on s8
// wgmma.
//
// Replaces (TPU side) the s8 convs of reve_tpu/models/rrdb.py:apply_int8
// with the float32 steps that follow each, which XLA fused into one s8
// conv graph on the MXU:
//   _rdb_int8 (:247-265): conv i of a dense block, s8 x s8 -> s32, over
//       the concat of the block's quantized input and the i quantized
//       growth slices so far; _dq (:240-244), float32(y32) * sw + b (sw
//       alone: weights/quantize.py folds each concat part's activation
//       scale into its weight slice); convs 1-4 then _lrelu and the
//       quantize of the next slice, conv 5 then h * 0.2 + x_f;
//   apply_int8 (:315-327): out * 0.2 + b_in after the third dense block,
//       the quantize of the trunk output, conv_body and feat + dq.
//
// What it computes.  Over an s8 NHWC buffer of Cs channels a pixel (192 =
// nf + 4 gc in the model) it reads channels [0, Cin), Cin in {64, 96,
// 128, 160, 192}, convolves them with 3x3 s8 HWIO weights to Cout (32 or
// 64) s32 channels, dq = float32(acc) * sw[c] + b[c], and applies one
// epilogue, every step a float32 op rounded on its own (__fmul_rn,
// __fadd_rn: no FMA contraction), quant(v) = clip(rint(v * inv), +-127)
// half to even (reve::quant_s8; inv = float32(1 / s_next), formed by the
// wrapper as the reference forms it):
//   LRELU_Q  quant(where(dq >= 0, dq, dq * 0.2))  -> out8 (the growth
//            slice beside the channels read, in the same buffer)
//   RDB      z = dq * 0.2 + res (float32)  -> out; quant(z) -> out8 (the
//            first 64 channels of the other s8 buffer)
//   RRDB     z2 = (dq * 0.2 + res) * 0.2 + res2 -> out (res2's buffer,
//            in place: each tile's res2 is read before its store);
//            quant(z2) -> out8
//   ADD      dtype(float32(res) + dq) -> out (feat, in place; float32 or
//            bfloat16)
// Conv 5's quant uses the next statistic's scale (the next dense block's
// input, or conv_body's), so no quant pass runs inside the trunk.
// Accumulator headroom: 9 x 192 x 127^2 < 2^25 < 2^31; float32(acc) rounds
// to nearest even above 2^24, as the reference's astype does.
//
// Bound on an H100 SXM (3.35 TB/s, 1979 TOP/s s8 dense) per call of 4
// 1080p frames (8.29 M pixels), bytes for every form: LRELU_Q at Cin c
// reads c and writes 32 B a pixel (0.238 ms at 64 to 0.475 at 160); RDB
// reads 192 s8 + 256 float32 and writes 256 + 64 (768 B, 1.90 ms, against
// 1.83 TOP -> 0.93 ms); RRDB also reads b_in (1,024 B, 2.54 ms); ADD 320 B
// (0.79 ms).  The 346 launches of a model call: about 245 ms.
//
// Design.  An implicit GEMM with M = 64 pixels of a row, N = Cout, K = 9
// taps x Cin, on wgmma m64nNk32 with s32 accumulators in registers, in
// persistent blocks of two consumer teams of two warpgroups and a
// producer warpgroup (K7's layout, rrdb.cu; K4's s8 operand layout,
// conv3x3_s8.cu).
//  * Cin is walked in chunks of 64 channels: a 64-channel s8 pixel is one
//    64-B row of the A operand in the 64-B swizzle (tap (dy, dx) starts
//    dy * 66 + dx rows later, k32 step kc 32 B into the row).  Cin = 96
//    and 160 end in a half chunk: the halo map's channel count is Cin, so
//    TMA fills channels Cin..63 of the last box with zeros (never reading
//    the growth slices that later convs write there), and the packed
//    weights hold zeros for them.  The weights of all chunks (at most 3 x
//    9 x 64 x 64 = 110,592 B) come in once per block by one bulk copy and
//    stay resident.
//  * Tiles: at Cout 32 (convs 1-4, 276 of a call's 346 launches) 8 x 64
//    pixels, four rows a warpgroup, so a halo box, (8+2) x (64+2) pixels,
//    is 1.29x the tile (4 x 64: 1.55x); at Cout 64 4 x 64, two rows a
//    warpgroup (the resident weights and the float32 staging leave no
//    room for taller halos).  Either way 64 accumulator registers.
//  * The epilogue overlaps the other team's wgmmas: the teams take the
//    block's tiles in turn, and a team issues its mainloop only after the
//    other team has issued its own (`turn`), so the halos are read in the
//    order they come, and one team's epilogue runs while the other's
//    wgmmas keep the tensor cores busy.  (A warpgroup that reads one
//    accumulator set while its own wgmmas write another makes ptxas wait
//    for those wgmmas and spill: a first draft so built took longer than
//    the kernel it replaced.)
//  * Outputs and residuals pass through shared memory, moved by TMA: the
//    producer's staging thread loads a tile's `res` (and, once the team
//    has read it, the RRDB form's res2) into the float staging, the team
//    computes in place over it, and the same thread stores the float
//    outputs, then (once the team has put the s8 codes where the values
//    were) the s8 codes; LRELU_Q stages only s8 codes, a buffer a team.
//    Float values sit in 128-B pixel rows of 32 channels (the 128-B
//    swizzle, so a warp's pairs hit every bank), s8 codes in N-byte pixel
//    rows.  The s8 store map covers exactly the Cout channels at out8 of
//    out8_px-byte pixels, so it never writes the channels [0, Cin) that
//    neighbouring tiles read through their halos.  Each team's handoffs
//    with the staging thread alternate on two barriers (ready, full).
//  * The producer warpgroup's threads each run one ring: halos (three
//    stages; two where the staging holds floats or a tile takes two
//    chunks), the weights, the staging; setmaxnreg hands the others'
//    registers to the consumers.  The warpgroups release a halo stage
//    with a predicated arrival after the wgmmas that read it are waited
//    on, so no branch on the thread index sits between a wgmma and its
//    wait.
//  * What bounds LRELU_Q now is the buffer's layout: its 32-B growth
//    slice inside each 192-B pixel.  Writing the same codes into a dense
//    32-channel tensor took 0.46-0.69 ms at Cin 64-128 on an H100 SXM
//    against 0.82-1.10 into the model's buffer.
#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace reve::tc;

constexpr int CK = 64;   // input channels per chunk: one 64-B A row
constexpr int TEAMS = 2;     // consumer teams, taking turns by tile
constexpr int TEAM_WGS = 2;  // warpgroups a team
constexpr int WGS = TEAMS * TEAM_WGS;
constexpr int TW = 64;   // tile columns: the M of one wgmma
constexpr int THREADS = 128 * (WGS + 1);  // + the producer warpgroup
// registers a thread, as K7's (rrdb.cu): __launch_bounds__(THREADS, 1)
// gives each 65,536 / THREADS rounded down to 8 (96), and launch() refuses
// a kernel that ptxas gave any other count, because setmaxnreg.inc waits
// until the block's own registers cover it: a budget the block does not
// hold hangs the card instead of failing.
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 112;
static_assert(PRODUCER_REGS + WGS * CONSUMER_REGS <= (WGS + 1) * LAUNCH_REGS,
              "more registers than the block was launched with");
constexpr int MAX_CHUNKS = 3;  // Cin <= 192

enum Epilogue { LRELU_Q = 0, RDB = 1, RRDB = 2, ADD = 3 };

// RES: the forms with float residuals and outputs (RDB, RRDB, ADD), whose
// staging holds float values, one buffer; else (LRELU_Q) the staging
// holds s8 codes, a buffer a team.
template <int N, bool RES>
struct K7q {
  static constexpr int RPW = N == 32 ? 4 : 2;  // tile rows a warpgroup
  static constexpr int TH = TEAM_WGS * RPW;    // tile rows
  static constexpr int HALO_TX = (TH + 2) * (TW + 2) * CK;  // one box
  static constexpr int HALO_BYTES = (HALO_TX + 1023) / 1024 * 1024;
  static constexpr int HS = RES ? 2 : 3;       // halo stages held
  static constexpr int CHUNK_W = 9 * CK * N;   // one chunk's packed weights
  // float values in 128-B pixel rows, one block of rows per 32 channels
  static constexpr int BLOCK = TH * TW * 128;
  static constexpr int ST_BUF = RES ? N / 32 * BLOCK : TH * TW * N;
  static constexpr int ST_BUFS = RES ? 1 : TEAMS;
  static constexpr size_t OFF_W = (size_t)HS * HALO_BYTES;
  static constexpr size_t OFF_ST = OFF_W + (size_t)MAX_CHUNKS * CHUNK_W;
  static constexpr size_t OFF_PAR = OFF_ST + ST_BUFS * ST_BUF;  // sw, b
  static constexpr size_t OFF_BAR = OFF_PAR + 2 * N * sizeof(float);
  // barriers: HS halo full, HS halo empty, the weights, and a team each:
  // its turn, staging ready (staging thread -> team), staging full (team
  // -> staging thread)
  static constexpr size_t SMEM =
      OFF_BAR + (2 * HS + 1 + 3 * TEAMS) * sizeof(uint64_t);
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
  static_assert(OFF_ST % 1024 == 0 && ST_BUF % 1024 == 0,
                "the staging buffers' swizzle");
};

// Byte offset in the float staging of channel c of tile pixel (r, p), for
// values of `es` bytes (4 float32, 2 bfloat16) in 128-B pixel rows.
template <int N, bool RES>
__device__ __forceinline__ uint32_t val_off(int r, int p, int c, int es) {
  const int cpr = 128 / es;  // channels a 128-B row
  return (uint32_t)(c / cpr) * K7q<N, RES>::BLOCK +
         swizzle<128>((uint32_t)((r * TW + p) * 128 + (c % cpr) * es));
}

// Byte offset in an s8 staging buffer of channel c of tile pixel (r, p):
// N-byte pixel rows, in the 64-B swizzle at N = 64 (none at 32).
template <int N>
__device__ __forceinline__ uint32_t s8_off(int r, int p, int c) {
  const uint32_t o = (uint32_t)((r * TW + p) * N + c);
  if constexpr (N == 64) return swizzle<64>(o);
  return o;
}

// The wgmmas of one chunk into the warpgroup's RPW rows: `a_rows` its
// first halo row in the stage, `wc` the chunk's weights; one group.  Rows
// innermost, so each k step's B descriptor serves its rows and dies (rows
// outermost, ptxas kept all 18 live and spilled at four rows: 0.59 ms
// against 0.29 for the wgmmas of lrelu_q at Cin 64).
template <int N, int RPW>
__device__ __forceinline__ void issue_chunk(int (&acc)[RPW][N / 2],
                                            uint32_t a_rows, uint32_t wc) {
#pragma unroll
  for (int s = 0; s < RPW; ++s) fence_regs(acc[s]);
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int kc = 0; kc < CK / 32; ++kc)
#pragma unroll
      for (int s = 0; s < RPW; ++s) {
        const uint32_t a =
            a_rows + ((s + tap / 3) * (TW + 2) + tap % 3) * CK + kc * 32;
        const uint32_t bw = wc + (tap * 4 + 2 * kc) * N * 16;
        WgmmaS8<N>::mma(acc[s], desc_sw64(a), desc(bw, N * 16));
      }
  wgmma_commit();
#pragma unroll
  for (int s = 0; s < RPW; ++s) fence_regs(acc[s]);
}

// The s8 codes of a float pair, in the low 16 bits
__device__ __forceinline__ int codes(float z0, float z1, float inv) {
  return (int)(reve::quant_s8(z0, inv) | (reve::quant_s8(z1, inv) << 8));
}

// map: the halo loads (the Cin channels of the Cs-byte pixels); res_map,
// res2_map, out_map (RES): boxes of the tile's float values (32 float32
// or 64 bfloat16 channels a box) of `res`, `res2`, `out`; out8_map: the
// tile's s8 codes, the Cout channels at out8 of out8_px-byte pixels.
template <int N, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
dense_conv_s8_kernel(const __grid_constant__ CUtensorMap map,
                     const __grid_constant__ CUtensorMap res_map,
                     const __grid_constant__ CUtensorMap res2_map,
                     const __grid_constant__ CUtensorMap out_map,
                     const __grid_constant__ CUtensorMap out8_map,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ sw,
                     const float* __restrict__ bias,
                     const float* __restrict__ inv_next, int epi,
                     int feat_bf16, int chunks, int B, int H, int W) {
  using K = K7q<N, RES>;
  constexpr int RPW = K::RPW, HS = K::HS;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;

  float* ps = reinterpret_cast<float*>(smem + K::OFF_PAR);
  for (int i = tid; i < N; i += THREADS) {
    ps[i] = sw[i];
    ps[N + i] = bias[i];
  }
  const uint32_t halo_full = base + (uint32_t)K::OFF_BAR;
  const uint32_t halo_empty = halo_full + 8 * HS;
  const uint32_t w_full = halo_empty + 8 * HS;
  const uint32_t turn = w_full + 8;               // + 8 * team
  const uint32_t st_ready = turn + 8 * TEAMS;     // + 8 * team
  const uint32_t st_full = st_ready + 8 * TEAMS;  // + 8 * team
  if (tid == 0) {
    for (int s = 0; s < HS; ++s) {
      mbar_init(halo_full + 8 * s, 1);
      mbar_init(halo_empty + 8 * s, TEAM_WGS);
    }
    mbar_init(w_full, 1);
    for (int m = 0; m < TEAMS; ++m) {
      mbar_init(turn + 8 * m, TEAM_WGS);
      mbar_init(st_ready + 8 * m, 1);
      mbar_init(st_full + 8 * m, 128 * TEAM_WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const TileGrid<K::TH, TW> g(B, H, W);
  const uint32_t st = base + (uint32_t)K::OFF_ST;
  // float values a 128-B row (32 float32 or 64 bfloat16), the boxes of a
  // tile's values and their bytes
  const int es = feat_bf16 ? 2 : 4, cpr = 128 / es;
  const int boxes = (N + cpr - 1) / cpr;
  const uint32_t val_bytes = boxes * K::BLOCK;
  // handoffs on each of a team's staging barriers a tile: RES, the
  // residual (and res2) loaded / read, the float values staged, the s8
  // codes staged; else the s8 codes staged / stored
  const int handoffs = RES ? 1 + (epi == RRDB) + (epi != ADD) : 1;
  // halo stages in use: LRELU_Q at two chunks a tile (Cin 96, 128) ran
  // faster on two of its three on an H100 SXM (0.956 / 0.916 ms a call of
  // 4 1080p frames against 1.098 / 1.057 on three; at Cin 160 two took
  // 1.190 against 0.922)
  const int hs_n = !RES && chunks == 2 ? 2 : HS;

  if (wg == WGS) {
    // The producer: the first thread of warp 0 issues the halos in the
    // order the teams consume them (the gh-th halo of the block waits for
    // the team that read the one hs_n before it to release it), of warp 1
    // the weights, once, and of warp 2 the staging's loads and stores,
    // tile by tile, each after the team's arrival on its `full`.
    setmaxnreg_dec<PRODUCER_REGS>();
    const int role = t >> 5;
    if ((t & 31) != 0) return;
    if (role == 0) {
      int gh = 0;
      for (long long tile = blockIdx.x; tile < g.count; tile += gridDim.x) {
        int b, y0, x0;
        g.origin(tile, b, y0, x0);
        for (int c = 0; c < chunks; ++c, ++gh) {
          const int hs = gh % hs_n;
          if (gh >= hs_n)
            mbar_wait(halo_empty + 8 * hs, (uint32_t)((gh / hs_n - 1) & 1));
          mbar_expect_tx(halo_full + 8 * hs, K::HALO_TX);
          tma_load_4d(base + hs * K::HALO_BYTES, &map, halo_full + 8 * hs,
                      c * CK, x0 - 1, y0 - 1, b);
        }
      }
    } else if (role == 1) {
      const uint32_t wbytes = (uint32_t)chunks * K::CHUNK_W;
      mbar_expect_tx(w_full, wbytes);
      bulk_load(base + (uint32_t)K::OFF_W, w, wbytes, w_full);
    } else if (role == 2) {
      long long kk = 0;  // the block's tiles so far
      for (long long tile = blockIdx.x; tile < g.count;
           tile += gridDim.x, ++kk) {
        int b, y0, x0;
        g.origin(tile, b, y0, x0);
        const int team = (int)(kk & 1);
        const uint32_t ready = st_ready + 8 * team, full = st_full + 8 * team;
        // phases of `full` before this one: the team's tiles so far
        uint32_t nf = (uint32_t)(kk >> 1) * handoffs;
        if constexpr (RES) {
          // the tile's res, then (RRDB, once it is read) its res2 in the
          // same place; the float outputs once computed over them
          mbar_expect_tx(ready, val_bytes);
          for (int h = 0; h < boxes; ++h)
            tma_load_4d(st + h * K::BLOCK, &res_map, ready, h * cpr, x0, y0,
                        b);
          if (epi == RRDB) {
            mbar_wait(full, nf++ & 1);
            mbar_expect_tx(ready, val_bytes);
            for (int h = 0; h < N / 32; ++h)
              tma_load_4d(st + h * K::BLOCK, &res2_map, ready, h * 32, x0,
                          y0, b);
          }
          mbar_wait(full, nf++ & 1);
          for (int h = 0; h < boxes; ++h)
            tma_store_4d(&out_map, st + h * K::BLOCK, h * cpr, x0, y0, b);
          bulk_commit();
          bulk_wait_read<0>();
          if (epi == ADD) continue;
          // the team may put the s8 codes in the staging
          mbar_arrive_if(ready, true);
        }
        mbar_wait(full, nf & 1);
        tma_store_4d(&out8_map, st + (RES ? 0 : team * K::ST_BUF), 0, x0, y0,
                     b);
        bulk_commit();
        bulk_wait_read<0>();
        if constexpr (!RES) mbar_arrive_if(ready, true);
      }
      bulk_wait<0>();
    }
    return;
  }

  // The teams: team m takes the block's tiles m, m + 2, ...; its mainloop
  // follows the other team's last (`turn`), so the halos are read in the
  // order they come and one team's epilogue runs beside the other's
  // wgmmas.
  setmaxnreg_inc<CONSUMER_REGS>();
  const int team = wg / TEAM_WGS;
  const int lane = t & 31;
  const int p0 = (t >> 5) * 16 + (lane >> 2), c0 = (lane & 3) * 2;
  const float inv = epi == ADD ? 0.f : *inv_next;
  const float k02 = 0.2f;  // float32(0.2), as the reference's weak 0.2
  const int r0 = (wg % TEAM_WGS) * RPW;  // the warpgroup's first tile row
  const uint32_t row_off = r0 * (TW + 2) * CK;  // ... its first halo row
  const uint32_t wsm = base + (uint32_t)K::OFF_W;
  const uint32_t ready = st_ready + 8 * team, full = st_full + 8 * team;
  unsigned char* sts = smem + K::OFF_ST + (RES ? 0 : team * K::ST_BUF);
  mbar_wait(w_full, 0);
  int j = 0;  // the team's tiles so far
  for (long long tile = blockIdx.x + team * gridDim.x; tile < g.count;
       tile += TEAMS * gridDim.x, ++j) {
    const long long kk = 2LL * j + team;  // the block's tile index
    // the other team has issued its wgmmas of the block's tile kk - 1
    if (kk > 0) mbar_wait(turn + 8 * team, (uint32_t)((j - 1 + team) & 1));
    int acc[RPW][N / 2];
#pragma unroll
    for (int s = 0; s < RPW; ++s)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[s][i] = 0;
    int gh = (int)kk * chunks;  // the block's halo group
    for (int c = 0; c < chunks; ++c, ++gh) {
      const int hs = gh % hs_n;
      mbar_wait(halo_full + 8 * hs, (uint32_t)((gh / hs_n) & 1));
      issue_chunk<N, RPW>(acc, base + hs * K::HALO_BYTES + row_off,
                          wsm + c * K::CHUNK_W);
      // the chunk before this one is done: release its halo
      wgmma_wait<1>();
      mbar_arrive_if(halo_empty + 8 * ((gh + hs_n - 1) % hs_n),
                     c > 0 && t == 0);
    }
    // the other team's turn; then this tile's last wgmmas
    mbar_arrive_if(turn + 8 * (1 - team), t == 0);
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < RPW; ++s) fence_regs(acc[s]);
    mbar_arrive_if(halo_empty + 8 * ((gh - 1) % hs_n), t == 0);

    // The epilogue: accumulator register 4j + 2h + e holds pixel p0 + 8h,
    // channel 8j + c0 + e of the warpgroup's row s.  Each register is
    // turned into its value in place, and then into its pair's s8 codes.
    const auto dq = [&](int s, int q, int c) {
      return __fadd_rn(__fmul_rn(__int2float_rn(acc[s][q]), ps[c]),
                       ps[N + c]);
    };
    uint32_t nr = (uint32_t)j * handoffs;  // phases of `ready` so far
    if constexpr (!RES) {
      // the buffer is free once the team's last store has read it
      if (j > 0) mbar_wait(ready, (nr - 1) & 1);
#pragma unroll
      for (int s = 0; s < RPW; ++s)
#pragma unroll
        for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = 8 * jj + c0, q = 4 * jj + 2 * h;
            float v0 = dq(s, q, c), v1 = dq(s, q + 1, c + 1);
            v0 = v0 >= 0.f ? v0 : __fmul_rn(v0, k02);
            v1 = v1 >= 0.f ? v1 : __fmul_rn(v1, k02);
            *reinterpret_cast<uint16_t*>(
                sts + s8_off<N>(r0 + s, p0 + 8 * h, c)) =
                (uint16_t)codes(v0, v1, inv);
          }
      fence_proxy_async();
      mbar_arrive_if(full, true);
      continue;
    }
    mbar_wait(ready, nr++ & 1);  // res
#pragma unroll
    for (int s = 0; s < RPW; ++s)
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 8 * jj + c0, q = 4 * jj + 2 * h;
          const float v0 = dq(s, q, c), v1 = dq(s, q + 1, c + 1);
          unsigned char* sp = sts + val_off<N, RES>(r0 + s, p0 + 8 * h, c, es);
          if (epi == ADD && feat_bf16) {
            __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(sp);
            const float2 f = __bfloat1622float2(*p2);
            __nv_bfloat162 r;
            r.x = __float2bfloat16_rn(__fadd_rn(f.x, v0));
            r.y = __float2bfloat16_rn(__fadd_rn(f.y, v1));
            *p2 = r;
            continue;
          }
          float2* p2 = reinterpret_cast<float2*>(sp);
          const float2 x2 = *p2;
          if (epi == ADD) {
            *p2 = make_float2(__fadd_rn(x2.x, v0), __fadd_rn(x2.y, v1));
            continue;
          }
          const float z0 = __fadd_rn(__fmul_rn(v0, k02), x2.x),
                      z1 = __fadd_rn(__fmul_rn(v1, k02), x2.y);
          if (epi == RDB) {
            *p2 = make_float2(z0, z1);
            acc[s][q] = codes(z0, z1, inv);
          } else {
            acc[s][q] = __float_as_int(z0);
            acc[s][q + 1] = __float_as_int(z1);
          }
        }
    if (epi == RRDB) {
      // res is read: the staging thread loads res2 in its place
      mbar_arrive_if(full, true);
      mbar_wait(ready, nr++ & 1);
#pragma unroll
      for (int s = 0; s < RPW; ++s)
#pragma unroll
        for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = 8 * jj + c0, q = 4 * jj + 2 * h;
            float2* p2 = reinterpret_cast<float2*>(
                sts + val_off<N, RES>(r0 + s, p0 + 8 * h, c, 4));
            const float2 r2 = *p2;
            const float z0 = __fadd_rn(
                            __fmul_rn(__int_as_float(acc[s][q]), k02), r2.x),
                        z1 = __fadd_rn(
                            __fmul_rn(__int_as_float(acc[s][q + 1]), k02),
                            r2.y);
            *p2 = make_float2(z0, z1);
            acc[s][q] = codes(z0, z1, inv);
          }
    }
    // the float outputs are staged: the staging thread stores them
    fence_proxy_async();
    mbar_arrive_if(full, true);
    if (epi == ADD) continue;
    // once that store has read the staging, the s8 codes in its place
    mbar_wait(ready, nr & 1);
#pragma unroll
    for (int s = 0; s < RPW; ++s)
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint16_t*>(
              sts + s8_off<N>(r0 + s, p0 + 8 * h, 8 * jj + c0)) =
              (uint16_t)acc[s][4 * jj + 2 * h];
    fence_proxy_async();
    mbar_arrive_if(full, true);
  }
}

template <int N, bool RES>
cudaError_t launch(const void* x, const void* wp, const float* sw,
                   const float* b, const float* inv, const void* res,
                   const void* res2, void* out, void* out8, int B, int H,
                   int W, int cin, int cs, int out8_px, int epi,
                   int feat_bf16, cudaStream_t stream) {
  using K = K7q<N, RES>;
  const long long tiles =
      (long long)B * ((H + K::TH - 1) / K::TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  // the first Cin channels of the Cs-byte pixels; a box past Cin reads
  // zeros
  CUtensorMap map, res_map, res2_map, out_map, out8_map;
  cudaError_t err = halo_map(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, B,
                             H, W, TW + 2, K::TH + 2,
                             CU_TENSOR_MAP_SWIZZLE_64B, CK, cin, cs);
  if (err != cudaSuccess) return err;
  res_map = res2_map = out_map = out8_map = map;
  // the tile's float values (32 float32 or 64 bfloat16 channels a box, in
  // the 128-B swizzle) and s8 codes; stores clip at the frame
  const auto vals = [&](CUtensorMap* m, const void* p) {
    return feat_bf16
               ? halo_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, B, H, W,
                          TW, K::TH, CU_TENSOR_MAP_SWIZZLE_128B, 64, N)
               : halo_map(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p, B, H, W,
                          TW, K::TH, CU_TENSOR_MAP_SWIZZLE_128B, 32, N);
  };
  if (RES) err = vals(&res_map, res);
  if (err == cudaSuccess && RES) err = vals(&out_map, out);
  if (err == cudaSuccess && epi == RRDB) err = vals(&res2_map, res2);
  if (err == cudaSuccess && epi != ADD)
    err = halo_map(&out8_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, out8, B, H,
                   W, TW, K::TH,
                   N == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_NONE,
                   N, N, out8_px);
  if (err != cudaSuccess) return err;
  auto kernel = dense_conv_s8_kernel<N, RES>;
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
      map, res_map, res2_map, out_map, out8_map,
      static_cast<const int8_t*>(wp), sw, b, inv, epi, feat_bf16,
      (cin + CK - 1) / CK, B, H, W);
  return cudaGetLastError();
}

template <int N>
cudaError_t dispatch(const void* x, const void* wp, const float* sw,
                     const float* b, const float* inv, const void* res,
                     const void* res2, void* out, void* out8, int B, int H,
                     int W, int cin, int cs, int out8_px, int epi,
                     int feat_bf16, cudaStream_t stream) {
  if (cin <= 0 || cin % 32 || cin > cs || cin > MAX_CHUNKS * CK ||
      epi < LRELU_Q || epi > ADD || (feat_bf16 && epi != ADD))
    return cudaErrorInvalidValue;
  if ((epi != ADD && (out8 == nullptr || inv == nullptr)) ||
      (epi != LRELU_Q && (res == nullptr || out == nullptr)) ||
      (epi == RRDB && res2 == nullptr))
    return cudaErrorInvalidValue;
  return epi == LRELU_Q
             ? launch<N, false>(x, wp, sw, b, inv, res, res2, out, out8, B, H,
                                W, cin, cs, out8_px, epi, feat_bf16, stream)
             : launch<N, true>(x, wp, sw, b, inv, res, res2, out, out8, B, H,
                               W, cin, cs, out8_px, epi, feat_bf16, stream);
}

}  // namespace

// K7q: `x` the (B, H, W, cs) s8 buffer, of which the conv reads channels
// [0, cin); `wp` the weights packed as [cin / 64 rounded up][tap][k / 16]
// [n][16] s8, zeros past cin; `sw`, `b` cout float32 each; `inv` one
// float32, 1 / s_next (unused by ADD); `res`, `res2`, `out` (B, H, W,
// cout) float32 (ADD: res and out float32, or bfloat16 when feat_bf16);
// `out8` the first of the cout s8 channels it writes, pixels out8_px
// bytes apart (unused by ADD); `epi` 0 LRELU_Q, 1 RDB, 2 RRDB, 3 ADD.
// Every pointer 16-B aligned and out8_px a multiple of 16 (TMA).
// Returns a cudaError_t.
extern "C" int reve_dense_conv_s8(const void* x, const void* wp,
                                  const float* sw, const float* b,
                                  const float* inv, const void* res,
                                  const void* res2, void* out, void* out8,
                                  int B, int H, int W, int cin, int cs,
                                  int cout, int out8_px, int epi,
                                  int feat_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 32:
      return (int)dispatch<32>(x, wp, sw, b, inv, res, res2, out, out8, B, H,
                               W, cin, cs, out8_px, epi, feat_bf16, s);
    case 64:
      return (int)dispatch<64>(x, wp, sw, b, inv, res, res2, out, out8, B, H,
                               W, cin, cs, out8_px, epi, feat_bf16, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
