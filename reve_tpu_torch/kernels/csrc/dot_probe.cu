// P1 dot_loop: the int8/bf16 dot-rate probe on Hopper's tensor cores.
//   acc = sum_{i < loops} x @ w[(i % 2) * K : (i % 2 + 1) * K]
// x (M, K), w (2K, N), both row-major; s8 -> s32 or bf16 -> f32.
//
// Replaces (TPU side): the Pallas kernel of scripts/perf_pallas_int8.py:54-75
// (main.run.kernel, pallas_call at :72), which loops a (4224,256)@(256,128)
// dot with alternating K-halves of a (512,128) weight, so the dot cannot be
// hoisted, and reports the MXU's s8 and bf16 dot rates.
//
// Bound on an H100 SXM at the probe's shape (M=4224, K=256, N=128,
// loops=64): 17.7 GOP per call / 1979 TOP/s (s8 dense) = 0.009 ms, / 989
// TFLOP/s (bf16 dense) = 0.018 ms; its bytes (0.6 MB) are negligible.
//
// Design: wgmma m64n64 (k32 s8, k16 bf16) with A from registers, so each
// warpgroup's mainloop is one chain of wgmmas into one accumulator that
// reads only B from shared memory.
//  * One CTA of WGS = 2 warpgroups per 64 x 64 output tile (66 x 2 = 132
//    CTAs at the probe's shape: one per SM).  The loop is split over the
//    warpgroups: warpgroup g runs the dots i = g, g + WGS, ..., each
//    against w's half i % 2, so each warpgroup reads one K-half.  Every
//    dot is issued: its half is chosen from the loop index and the wgmmas
//    are volatile asm.
//  * The float32 sum (bf16): warpgroup g adds its dots' k steps in order
//    into its accumulator (the tensor cores add within a k step in their
//    own order); the tile is the warpgroups' sums added in order, 0 first:
//    sum(even dots) + sum(odd dots).  s8 sums are exact in any order.
//  * Prologue, once per CTA: each warpgroup loads its tile's 64 rows of x
//    straight into the A fragments (KS k steps of 32 B, 4 registers each:
//    32 a thread in s8 and 64 in bf16 at K = 256); the threads transpose
//    both halves of w into B K-major, [16-B chunk of k][n][16 B] (core
//    matrices of 8 columns x 16 B, no swizzle: tc.cuh desc()), from 4-B
//    words of w with byte permutes.  (Its first form, a byte or a bf16 a
//    load in a loop that was not unrolled, took about 7 us of a 22-us s8
//    call on an H100 SXM: each thread waited out the latency of 16 or 32
//    rounds of loads.)
//  * Mainloop: per dot KS wgmmas in one commit group, at most two groups in
//    flight (wgmma_wait<1>); nothing between a wgmma and its wait branches
//    on the thread index.
//  * Epilogue: each warpgroup writes its fragment to shared memory; after a
//    barrier the threads add the two sums and store them as 16-B vectors.
//  * Why two warpgroups on a 64 x 64 tile and not a cluster of 2 CTAs of
//    one warpgroup on each 64 x 128 tile (m64n128), their sums added
//    through distributed shared memory: on an H100 SXM both run their
//    dots at the same rate, but the cluster took 1.5 us (s8) to 4.5 us
//    (bf16) more a call (half the threads stage the same bytes, and it
//    waits at two cluster barriers).  perf_conv_tc_parts times this
//    kernel with one warpgroup and without its prologue.
#include "tc.cuh"

namespace {

using namespace reve::tc;

// consumer warpgroups of a CTA: they split the loop between them
constexpr int WGS = 2;
constexpr int BM = 64, BN = 64;  // a tile: one m64n64 wgmma
constexpr int THREADS = 128 * WGS;
// row stride (values) of a warpgroup's sums: 8 past BN, so the 8-B
// stores of a fragment's 8 rows fill the banks twice, without conflicts
constexpr int RED_LD = BN + 8;

template <typename T>
struct Op;

template <>
struct Op<int8_t> {
  using Acc = int;
  static constexpr int KS_MAX = 8;  // k steps of 32 B (k32): K <= 256
  __device__ static void mma(int (&d)[BN / 2], const uint32_t (&a)[4],
                             uint64_t b) {
    WgmmaS8<BN>::mma(d, a, b);
  }
  __device__ static void add(int4& s, const int4& v) {
    s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
  }
};

template <>
struct Op<__nv_bfloat16> {
  using Acc = float;
  static constexpr int KS_MAX = 16;  // k steps of 32 B (k16): K <= 256
  __device__ static void mma(float (&d)[BN / 2], const uint32_t (&a)[4],
                             uint64_t b) {
    Wgmma<BN>::mma(d, a, b);
  }
  __device__ static void add(float4& s, const float4& v) {
    s.x = __fadd_rn(s.x, v.x), s.y = __fadd_rn(s.y, v.y);
    s.z = __fadd_rn(s.z, v.z), s.w = __fadd_rn(s.w, v.w);
  }
};

template <typename A>
struct Vec;
template <>
struct Vec<int> {
  using Two = int2;
  using Four = int4;
};
template <>
struct Vec<float> {
  using Two = float2;
  using Four = float4;
};

// Stage one K-half of w (`src`: its row 0, N values a row) as B for the
// tile's columns n0 .. n0 + BN - 1, K-major: value (k, n) at 16-B chunk k /
// E, row n, byte (k % E) * sizeof(T) (tc.cuh desc(): core matrices of 8
// rows x 16 B, no swizzle).  A thread reads one 4-B word of each of a
// chunk's E rows (4 / sizeof(T) columns; neighbouring threads read
// neighbouring words) and transposes them in registers into that chunk of
// each of its columns.  The loop is unrolled (by 4 at most, so the words
// in flight fit in the registers), so a thread's loads are in flight
// together.
template <typename T, int K>
__device__ __forceinline__ void stage_half(uint4* dst, const T* src, int N,
                                           int n0, int tid) {
  constexpr int E = 16 / (int)sizeof(T), C = 4 / (int)sizeof(T);
  constexpr int G = BN / C, UNITS = K / E * G;
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
#pragma unroll 4
  for (int it = 0; it < (UNITS + THREADS - 1) / THREADS; ++it) {
    const int u = it * THREADS + tid;
    if (u < UNITS) {
      const int kc = u / G, n = (u - kc * G) * C;
      uint32_t in[E], o[C][4];
#pragma unroll
      for (int j = 0; j < E; ++j)
        in[j] = __ldg(reinterpret_cast<const uint32_t*>(
            s + ((size_t)(kc * E + j) * N + n0 + n) * sizeof(T)));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (C == 4) {  // s8: 4 x 4 bytes, rows 4q .. 4q + 3
          const uint32_t t0 = __byte_perm(in[4 * q], in[4 * q + 1], 0x5140);
          const uint32_t t1 = __byte_perm(in[4 * q], in[4 * q + 1], 0x7362);
          const uint32_t t2 =
              __byte_perm(in[4 * q + 2], in[4 * q + 3], 0x5140);
          const uint32_t t3 =
              __byte_perm(in[4 * q + 2], in[4 * q + 3], 0x7362);
          o[0][q] = __byte_perm(t0, t2, 0x5410);
          o[1][q] = __byte_perm(t0, t2, 0x7632);
          o[2][q] = __byte_perm(t1, t3, 0x5410);
          o[3][q] = __byte_perm(t1, t3, 0x7632);
        } else {  // bf16: 2 x 2 values, rows 2q, 2q + 1
          o[0][q] = __byte_perm(in[2 * q], in[2 * q + 1], 0x5410);
          o[1][q] = __byte_perm(in[2 * q], in[2 * q + 1], 0x7632);
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        dst[kc * BN + n + c] = make_uint4(o[c][0], o[c][1], o[c][2], o[c][3]);
    }
  }
}

// Shared memory: room for both halves of B, then the warpgroups' sums.
template <typename T, int KS>
constexpr size_t smem_bytes() {
  return 2 * (size_t)KS * 32 * BN +
         (size_t)WGS * BM * RED_LD * sizeof(typename Op<T>::Acc);
}

template <typename T, int KS>
__global__ void __launch_bounds__(THREADS, 1)
dot_loop_kernel(const T* __restrict__ x, const T* __restrict__ w,
                typename Op<T>::Acc* __restrict__ out, int N, int loops) {
  using Acc = typename Op<T>::Acc;
  using V2 = typename Vec<Acc>::Two;
  using V4 = typename Vec<Acc>::Four;
  constexpr int KB = KS * 32;                // bytes of a row of x
  constexpr int K = KB / (int)sizeof(T);
  constexpr int HALF = KB * BN;              // bytes of one half of B
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tiles_n = N / BN;
  const int m0 = blockIdx.x / tiles_n * BM, n0 = blockIdx.x % tiles_n * BN;
  const int tid = threadIdx.x;
  // the warpgroup, through a shuffle: the compiler then knows it is
  // uniform in the warp
  const int wg = WGS == 1 ? 0 : __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int t = tid & 127, lane = t & 31, warp = t >> 5;

  // B: both halves of w
  for (int h = 0; h < 2; ++h)
    stage_half<T, K>(reinterpret_cast<uint4*>(smem + h * HALF),
                     w + (size_t)h * K * N, N, n0, tid);

  // A: the tile's rows of x as the wgmma fragment of each k step s:
  // register r holds row 16 * warp + lane / 4 + 8 * (r % 2), bytes 32 s +
  // 16 * (r / 2) + 4 * (lane % 4) of it (tc.cuh)
  const unsigned char* xr = reinterpret_cast<const unsigned char*>(x) +
                            (size_t)(m0 + 16 * warp + (lane >> 2)) * KB +
                            4 * (lane & 3);
  uint32_t a[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[s][r] = __ldg(reinterpret_cast<const uint32_t*>(
          xr + (r & 1) * 8 * KB + 32 * s + 16 * (r >> 1)));

  Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = Acc(0);
  fence_proxy_async();  // the staged B becomes visible to wgmma
  __syncthreads();

  const uint32_t wb = smem_u32(smem);
  fence_regs(acc);
#pragma unroll 1
  for (int i = wg; i < loops; i += WGS) {
    const uint32_t b = wb + (i & 1) * HALF;  // the dot's K-half
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KS; ++s)
      Op<T>::mma(acc, a[s], desc(b + s * 2 * BN * 16, BN * 16));
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(acc);  // every read of the accumulators stays below the wait

  // this warpgroup's sums, row-major at stride RED_LD: fragment register
  // 4j + 2h + e holds row 16 * warp + lane / 4 + 8h, column 8j + 2 *
  // (lane % 4) + e
  Acc* red = reinterpret_cast<Acc*>(smem + 2 * HALF);
  Acc* mine = red + wg * BM * RED_LD;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      V2 v;
      v.x = acc[4 * j + 2 * h], v.y = acc[4 * j + 2 * h + 1];
      *reinterpret_cast<V2*>(mine +
                             (16 * warp + (lane >> 2) + 8 * h) * RED_LD +
                             8 * j + 2 * (lane & 3)) = v;
    }
  __syncthreads();

  // the tile: the warpgroups' sums added in order
  constexpr int VPR = BN / 4;  // 16-B vectors per row
  for (int q = tid; q < BM * VPR; q += THREADS) {
    const int row = q / VPR, col = (q - row * VPR) * 4;
    V4 s = *reinterpret_cast<const V4*>(red + row * RED_LD + col);
#pragma unroll
    for (int g = 1; g < WGS; ++g)
      Op<T>::add(s, *reinterpret_cast<const V4*>(red + (g * BM + row) *
                                                     RED_LD + col));
    *reinterpret_cast<V4*>(out + (size_t)(m0 + row) * N + n0 + col) = s;
  }
}

template <typename T, int KS>
cudaError_t launch(const void* x, const void* w, void* out, int M, int N,
                   int loops, cudaStream_t stream) {
  constexpr size_t SMEM = smem_bytes<T, KS>();
  auto kernel = dot_loop_kernel<T, KS>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<M / BM * (N / BN), THREADS, SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<typename Op<T>::Acc*>(out), N, loops);
  return cudaGetLastError();
}

// launch<T, ks>: one kernel for each count of k steps, so that the A
// fragments sit in registers and the mainloop is unrolled
template <typename T, int KS = 1>
cudaError_t dispatch(int ks, const void* x, const void* w, void* out, int M,
                     int N, int loops, cudaStream_t stream) {
  if (ks == KS) return launch<T, KS>(x, w, out, M, N, loops, stream);
  if constexpr (KS < Op<T>::KS_MAX)
    return dispatch<T, KS + 1>(ks, x, w, out, M, N, loops, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = s8 -> s32, 1 = bf16 -> f32.  M and N positive multiples of 64,
// K at most 256 and a positive multiple of 32 (s8) or 16 (bf16), loops >=
// 0.  Returns a cudaError_t (0 = success).
extern "C" int reve_dot_loop(const void* x, const void* w, void* out, int M,
                             int N, int K, int loops, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || M % BM || N <= 0 || N % BN || K <= 0 || K > 256 || loops < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && K % 32 == 0)
    return (int)dispatch<int8_t>(K / 32, x, w, out, M, N, loops, s);
  if (dtype == 1 && K % 16 == 0)
    return (int)dispatch<__nv_bfloat16>(K / 16, x, w, out, M, N, loops, s);
  return (int)cudaErrorInvalidValue;
}
