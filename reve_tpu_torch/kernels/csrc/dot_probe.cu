// P1 dot_loop: the int8/bf16 dot-rate probe on the tensor cores.
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
// Design: warp-level mma.sync (m16n8k32 s8, m16n8k16 bf16) from shared
// memory; wgmma, which the card needs for its full rate, is later work.  One
// block per 64x64 output tile (66 x 2 = 132 blocks at the probe's shape, one
// per SM), 4 warps of 32x32 each.  The block stages its 64 rows of x and the
// 64 columns of both K-halves of w, transposed to [n][k] so a B fragment is
// one 32-bit load, at a row stride padded by 16 bytes so the 8 rows a
// fragment load touches hit distinct banks.  The loop over `loops` selects
// the K-half from the loop index, as the Pallas kernel does, and the mma is
// volatile asm, so neither can be hoisted or merged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64, BN = 64, THREADS = 128;

template <typename T>
struct Mma;

template <>
struct Mma<int8_t> {
  using Acc = int;
  static constexpr int KSTEP = 32;  // k per mma, elements
  static constexpr int EPW = 4;     // elements per 32-bit register
  __device__ static void run(Acc (&d)[4], const uint32_t (&a)[4],
                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Mma<__nv_bfloat16> {
  using Acc = float;
  static constexpr int KSTEP = 16;
  static constexpr int EPW = 2;
  __device__ static void run(Acc (&d)[4], const uint32_t (&a)[4],
                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <typename T>
__host__ __device__ constexpr int row_stride(int K) {
  return K + 16 / (int)sizeof(T);  // +16 bytes: 4 banks of skew per row
}

template <typename T>
size_t smem_bytes(int K) {
  return (size_t)(BM + 2 * BN) * row_stride<T>(K) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dot_loop_kernel(const T* __restrict__ x, const T* __restrict__ w,
                typename Mma<T>::Acc* __restrict__ out, int N, int K,
                int loops) {
  using M = Mma<T>;
  using Acc = typename M::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = row_stride<T>(K);
  T* xs = reinterpret_cast<T*>(smem);  // [BM][ld]
  T* wt = xs + BM * ld;                // [2][BN][ld], transposed halves
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  for (int i = tid; i < BM * K; i += THREADS) {
    const int r = i / K, k = i - r * K;
    xs[r * ld + k] = x[(size_t)(m0 + r) * K + k];
  }
  for (int i = tid; i < 2 * K * BN; i += THREADS) {
    const int kk = i / BN, n = i - kk * BN;  // kk in [0, 2K): row of w
    const int half = kk / K, k = kk - half * K;
    wt[(half * BN + n) * ld + k] = w[(size_t)kk * N + n0 + n];
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  Acc acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = Acc(0);

  constexpr int KS = M::KSTEP, E = M::EPW;
#pragma unroll 1
  for (int it = 0; it < loops; ++it) {
    const T* wh = wt + (it & 1) * BN * ld;  // the loop-dependent K-half
#pragma unroll 1
    for (int k0 = 0; k0 < K; k0 += KS) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const T* xr = xs + (wm + 16 * a + g) * ld + k0 + t * E;
        af[a][0] = *reinterpret_cast<const uint32_t*>(xr);
        af[a][1] = *reinterpret_cast<const uint32_t*>(xr + 8 * ld);
        af[a][2] = *reinterpret_cast<const uint32_t*>(xr + KS / 2);
        af[a][3] = *reinterpret_cast<const uint32_t*>(xr + 8 * ld + KS / 2);
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const T* wr = wh + (wn + 8 * b + g) * ld + k0 + t * E;
        bf[b][0] = *reinterpret_cast<const uint32_t*>(wr);
        bf[b][1] = *reinterpret_cast<const uint32_t*>(wr + KS / 2);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) M::run(acc[a][b], af[a], bf[b]);
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = m0 + wm + 16 * a + g, c = n0 + wn + 8 * b + 2 * t;
      out[(size_t)r * N + c] = acc[a][b][0];
      out[(size_t)r * N + c + 1] = acc[a][b][1];
      out[(size_t)(r + 8) * N + c] = acc[a][b][2];
      out[(size_t)(r + 8) * N + c + 1] = acc[a][b][3];
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int M, int N,
                   int K, int loops, cudaStream_t stream) {
  if (M % BM || N % BN || K % Mma<T>::KSTEP || loops < 0)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(K);
  auto kernel = dot_loop_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(M / BM, N / BN), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<typename Mma<T>::Acc*>(out), N, K, loops);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = s8 -> s32, 1 = bf16 -> f32.  Returns a cudaError_t.
extern "C" int reve_dot_loop(const void* x, const void* w, void* out, int M,
                             int N, int K, int loops, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<int8_t>(x, w, out, M, N, K, loops, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, out, M, N, K, loops, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* reve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
