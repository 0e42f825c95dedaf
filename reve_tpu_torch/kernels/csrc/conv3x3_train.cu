// T2 conv3x3_dgrad: SRVGG's conv3x3 input gradient for training, in float32
// on the CUDA cores.  Its d(alpha) block partials are summed by
// train.cuh's sum_parts, in block order.
//
//   T2 conv3x3_dgrad      dx = conv3x3^T(dz, W) (W rotated 180 degrees, in
//                         and out swapped), times the previous layer's
//                         PReLU'(z), and that layer's d(alpha) =
//                         sum dx * min(z, 0) as per-block partial sums
//
// T1 (the forward) and T3 (the weight gradient) run on the tensor cores
// in conv3x3_train_tc.cu.
//
// Replaces (TPU side): the input gradient XLA's autodiff derives from
// reve_tpu/models/srvgg.py:88-113 (`_conv3x3` at Precision.HIGHEST and
// `_prelu`) as reve_tpu/train/trainer.py:53-72 runs them under
// jax.value_and_grad.  PReLU's derivative at z = 0 is JAX's (1 + alpha) /
// 2 (lax.max and lax.min split a tie's gradient in halves), and d(alpha)
// there is 0.
//
// Layouts: NHWC float32 activations, HWIO float32 weights; channel counts
// are template parameters, Cin in {3, 64, 128} and Cout in {48, 64, 128}.
//
// Bound on an H100 SXM (67 TFLOP/s float32 outside the tensor cores,
// 3.35 TB/s): a 64 -> 64 conv over a step's 8 x 64 x 64 LR pixels is
// 2.416 GFLOP -> 0.036 ms, its bytes about 25 MB -> 0.0075 ms, so it is
// bound by its operations.
//
// Design: one implicit GEMM, C[M, N] += A[M, K] B[K, N], on float32 FMAs:
// M = pixels, N = Cin, K = 9 Cout, A dz gathered at the mirrored taps, B
// the weights read transposed per tap.  A block of 256 threads takes a
// 128 x 64 tile of C through 8-deep K steps staged in shared memory (the
// next step's global loads in flight in registers while this one is
// summed); a thread sums 8 x 4 outputs.  Its d(alpha) partials, one row a
// block row, are summed by sum_parts in block order: no float atomics, so
// a training step repeats bit for bit.
#include "train.cuh"

namespace {

using reve::train::dispatch;
using reve::train::sum_parts;

constexpr int THREADS = 256;
constexpr int BM = 128, BN = 64, BK = 8;
constexpr int APAD = BM + 4, BPAD = BN + 4;  // conflict-free stores

struct Geo {
  int H, W, npix;
};

// the neighbour of pixel p at offset (dy, dx), or -1 outside its image
__device__ __forceinline__ int neighbour(const Geo& g, int p, int y, int x,
                                         int dy, int dx) {
  const int yy = y + dy, xx = x + dx;
  if (p >= g.npix || yy < 0 || yy >= g.H || xx < 0 || xx >= g.W) return -1;
  return p + dy * g.W + dx;
}

// What a thread loads for one K step: 4 values of A, 2 of B.
struct Frag {
  float a[4];
  float b[2];
};

// T2's loaders for a layer CIN -> COUT: A[m = pixel, k = tap * COUT + co]
// = dz at the mirrored tap (dx(p) = sum dz(p - t) W[t]), B[k = tap * COUT
// + co, n = ci] = W[tap][ci][co].  A thread's A loads are for one fixed
// pixel, decoded once.
template <int CIN, int COUT>
struct Op {
  static constexpr int K_LEN = 9 * COUT;
  static constexpr bool VEC = COUT % 4 == 0;

  const float* a_src;  // dz
  const float* b_src;  // w
  Geo g;
  int m0, n0;
  // the fixed pixel of this thread's A loads
  int ap, ay, ax;

  __device__ void init(int tid) {
    ap = m0 + (VEC ? tid / 2 : tid % BM);
    ax = ap % g.W;
    ay = (ap / g.W) % g.H;
  }

  __device__ void fetch(int kt, int tid, Frag& f) const {
    if (VEC) {
      const int k = kt + (tid & 1) * 4;
      const int tap = k / COUT, c = k % COUT;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const int q = neighbour(g, ap, ay, ax, -dy, -dx);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q >= 0 && k < K_LEN)
        v = *reinterpret_cast<const float4*>(a_src + (long long)q * COUT + c);
      f.a[0] = v.x; f.a[1] = v.y; f.a[2] = v.z; f.a[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = kt + tid / BM + 2 * j;
        float v = 0.f;
        if (k < K_LEN) {
          const int tap = k / COUT, c = k % COUT;
          const int dy = tap / 3 - 1, dx = tap % 3 - 1;
          const int q = neighbour(g, ap, ay, ax, -dy, -dx);
          if (q >= 0) v = a_src[(long long)q * COUT + c];
        }
        f.a[j] = v;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + j * THREADS;
      const int k = kt + idx % BK, n = n0 + idx / BK;
      const int tap = k / COUT, co = k % COUT;
      f.b[j] = (k < K_LEN && n < CIN)
                   ? b_src[((long long)tap * CIN + n) * COUT + co]
                   : 0.f;
    }
  }

  __device__ void store(const Frag& f, int tid, float (*As)[APAD],
                        float (*Bs)[BPAD]) const {
    if (VEC) {
      const int mm = tid / 2, kq = (tid & 1) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) As[kq + j][mm] = f.a[j];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) As[tid / BM + 2 * j][tid % BM] = f.a[j];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + j * THREADS;
      Bs[idx % BK][idx / BK] = f.b[j];
    }
  }
};

// The shared main loop: acc[i][j] for rows tx*4 + i (i < 4) and 64 + tx*4
// + i - 4 (i >= 4) of the tile, columns ty*4 + j.
template <class O>
__device__ __forceinline__ void main_loop(const O& op, int k_begin, int k_end,
                                          int tid, float (&acc)[8][4]) {
  __shared__ __align__(16) float As[BK][APAD];
  __shared__ __align__(16) float Bs[BK][BPAD];
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  Frag f;
  op.fetch(k_begin, tid, f);
  for (int kt = k_begin; kt < k_end; kt += BK) {
    op.store(f, tid, As, Bs);
    __syncthreads();
    if (kt + BK < k_end) op.fetch(kt + BK, tid, f);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][tx * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][64 + tx * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][ty * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ int tile_row(int tx, int i) {
  return i < 4 ? tx * 4 + i : 64 + tx * 4 + (i - 4);
}

// JAX's PReLU vjp: dz = dy * s(z > 0) + (alpha dy) * s(z < 0), where s
// is 1, 0 or, at a tie z = 0, 0.5 (lax.max / lax.min's balanced
// gradient); d(alpha) += dy * min(z, 0).
__device__ __forceinline__ float prelu_grad(float dy, float z, float a) {
  if (z > 0.f) return dy;
  if (z < 0.f) return a * dy;
  return dy * 0.5f + (a * dy) * 0.5f;
}

// T2 for a layer CIN -> COUT: reads dz (COUT channels), writes the
// previous layer's dz (CIN channels) and its d(alpha) partial sums, one
// row of CIN a block row (blockIdx.x).
template <int CIN, int COUT>
__global__ void __launch_bounds__(THREADS)
    dgrad_kernel(const float* __restrict__ dz, const float* __restrict__ w,
                 const float* __restrict__ zprev,
                 const float* __restrict__ alpha, float* __restrict__ dzprev,
                 float* __restrict__ dalpha_part, Geo g) {
  using O = Op<CIN, COUT>;
  __shared__ float red[16][BN];
  const int tid = threadIdx.x;
  O op{dz, w, g, (int)blockIdx.x * BM, (int)blockIdx.y * BN};
  op.init(tid);
  float acc[8][4];
  main_loop(op, 0, O::K_LEN, tid, acc);
  const int tx = tid % 16, ty = tid / 16;
  const int n = op.n0 + ty * 4;
  float da[4] = {0.f, 0.f, 0.f, 0.f};
  if (CIN % 4 == 0 && n < CIN) {
    // a thread's 4 columns as one 16-B load or store
    const float4 a4 = *reinterpret_cast<const float4*>(alpha + n);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = op.m0 + tile_row(tx, i);
      if (m >= g.npix) continue;
      const long long o = (long long)m * CIN + n;
      const float4 z4 = *reinterpret_cast<const float4*>(zprev + o);
      const float zv[4] = {z4.x, z4.y, z4.z, z4.w};
      float d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        d[j] = prelu_grad(acc[i][j], zv[j], a[j]);
        da[j] = fmaf(acc[i][j], fminf(zv[j], 0.f), da[j]);
      }
      *reinterpret_cast<float4*>(dzprev + o) = make_float4(d[0], d[1], d[2],
                                                           d[3]);
    }
  } else if (CIN % 4 != 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n + j >= CIN) continue;
      const float a = alpha[n + j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = op.m0 + tile_row(tx, i);
        if (m >= g.npix) continue;
        const long long o = (long long)m * CIN + n + j;
        dzprev[o] = prelu_grad(acc[i][j], zprev[o], a);
        da[j] = fmaf(acc[i][j], fminf(zprev[o], 0.f), da[j]);
      }
    }
  }
  // the block's partial sums, column by column in a fixed order
#pragma unroll
  for (int j = 0; j < 4; ++j) red[tx][ty * 4 + j] = da[j];
  __syncthreads();
  if (tid < BN && op.n0 + tid < CIN) {
    float s = 0.f;
    for (int r = 0; r < 16; ++r) s += red[r][tid];
    dalpha_part[(long long)blockIdx.x * CIN + op.n0 + tid] = s;
  }
}

template <int CIN, int COUT>
struct Dgrad {
  static cudaError_t run(const float* dz, const float* w, const float* zprev,
                         const float* alpha, float* dzprev, float* part,
                         float* dalpha, Geo g, cudaStream_t st) {
    const int mt = (g.npix + BM - 1) / BM;
    dim3 grid(mt, (CIN + BN - 1) / BN);
    dgrad_kernel<CIN, COUT>
        <<<grid, THREADS, 0, st>>>(dz, w, zprev, alpha, dzprev, part, g);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return sum_parts(part, dalpha, mt, CIN, st);
  }
};

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a channel pair it does not take).  The
// wrapper (reve_tpu_torch/kernels/train.py) allocates every output and
// scratch buffer.

extern "C" int reve_conv3x3_dgrad(const float* dz, const float* w,
                                  const float* zprev, const float* alpha,
                                  float* dzprev, float* dalpha_part,
                                  float* dalpha, int B, int H, int W, int cin,
                                  int cout, void* stream) {
  const Geo g{H, W, B * H * W};
  if (g.npix == 0) return (int)cudaSuccess;
  return (int)dispatch<Dgrad>(cin, cout, dz, w, zprev, alpha, dzprev,
                              dalpha_part, dalpha, g,
                              static_cast<cudaStream_t>(stream));
}
