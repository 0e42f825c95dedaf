// T1-T3: SRVGG's conv3x3 for training, in float32 on the CUDA cores.
//
//   T1 conv3x3_fwd_train  z = conv3x3(x, W) + b; with a PReLU after it,
//                         y = PReLU(z), and z written beside y for the
//                         backward (the teacher's forward writes y only;
//                         the head has no PReLU and writes z)
//   T2 conv3x3_dgrad      dx = conv3x3^T(dz, W) (W rotated 180 degrees, in
//                         and out swapped), times the previous layer's
//                         PReLU'(z), and that layer's d(alpha) =
//                         sum dx * min(z, 0) as per-block partial sums
//   T3 conv3x3_wgrad      dW[ky,kx,ci,co] = sum_p x(p + k) dz(p) and
//                         db = sum_p dz(p), split over the pixels into
//                         partial sums, then reduced in a fixed order
//
// Replaces (TPU side): reve_tpu/models/srvgg.py:88-113 (`_conv3x3` at
// Precision.HIGHEST and `_prelu`) as reve_tpu/train/trainer.py:53-72 runs
// them under jax.value_and_grad: XLA's forward conv and the two convs its
// autodiff derives from it.  PReLU's derivative at z = 0 is JAX's
// (1 + alpha) / 2 (lax.max and lax.min split a tie's gradient in halves),
// and d(alpha) there is 0.
//
// Layouts: NHWC float32 activations, HWIO float32 weights; channel counts
// are template parameters, Cin in {3, 64, 128} and Cout in {48, 64, 128}.
//
// Bound on an H100 SXM (67 TFLOP/s float32 outside the tensor cores,
// 3.35 TB/s): a 64 -> 64 conv over a step's 8 x 64 x 64 LR pixels is
// 2.416 GFLOP -> 0.036 ms, its bytes about 25 MB -> 0.0075 ms, so each
// kernel is bound by its operations.
//
// Design: each kernel is one implicit GEMM, C[M, N] += A[M, K] B[K, N],
// on float32 FMAs, through one shared main loop:
//   T1  M = pixels, N = Cout, K = 9 Cin: A the input's halo gathered per
//       tap, B the HWIO weights as they lie;
//   T2  M = pixels, N = Cin, K = 9 Cout: A dz gathered at the mirrored
//       taps, B the weights read transposed per tap;
//   T3  M = 9 Cin + 1, N = Cout, K = pixels: A the input gathered per tap
//       with a row of ones appended (its row of C is db), B dz; K is
//       split over the grid's z and each split writes its partial C, which
//       a second kernel sums in split order: no float atomics anywhere, so
//       a training step repeats bit for bit.
// A block of 256 threads takes a 128 x 64 tile of C through 8-deep K
// steps staged in shared memory (the next step's global loads in flight
// in registers while this one is summed); a thread sums 8 x 4 outputs.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BM = 128, BN = 64, BK = 8;
constexpr int APAD = BM + 4, BPAD = BN + 4;  // conflict-free stores

enum Kind { FWD, DGRAD, WGRAD };

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

// The loaders and the epilogue of each kernel.  A thread's A loads of T1
// and T2 are for one fixed pixel, decoded once.
template <int KIND, int CIN, int COUT>
struct Op {
  // T1: A channels CIN, N = COUT; T2: A channels COUT, N = CIN
  static constexpr int AC = KIND == DGRAD ? COUT : CIN;
  static constexpr int N = KIND == DGRAD ? CIN : COUT;
  static constexpr int M_ROWS = 9 * CIN + 1;  // T3
  static constexpr int K_LEN = 9 * AC;        // T1, T2
  static constexpr bool VEC = (KIND == WGRAD ? CIN : AC) % 4 == 0;

  const float* a_src;  // T1, T3: x; T2: dz
  const float* b_src;  // T1, T2: w; T3: dz
  Geo g;
  int m0, n0;
  // the fixed pixel of this thread's A loads (T1, T2)
  int ap, ay, ax;

  __device__ void init(int tid) {
    if (KIND != WGRAD) {
      ap = m0 + (VEC ? tid / 2 : tid % BM);
      ax = ap % g.W;
      ay = (ap / g.W) % g.H;
    }
  }

  __device__ void fetch(int kt, int tid, Frag& f) const {
    if (KIND != WGRAD) {
      // A[m = pixel, k = tap * AC + c]
      if (VEC) {
        const int k = kt + (tid & 1) * 4;
        const int tap = k / AC, c = k % AC;
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        // T2 reads dz at the mirrored tap: dx(p) = sum dz(p - t) W[t]
        const int q = KIND == FWD ? neighbour(g, ap, ay, ax, dy, dx)
                                  : neighbour(g, ap, ay, ax, -dy, -dx);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q >= 0 && k < K_LEN)
          v = *reinterpret_cast<const float4*>(a_src + (long long)q * AC + c);
        f.a[0] = v.x; f.a[1] = v.y; f.a[2] = v.z; f.a[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = kt + tid / BM + 2 * j;
          float v = 0.f;
          if (k < K_LEN) {
            const int tap = k / AC, c = k % AC;
            const int dy = tap / 3 - 1, dx = tap % 3 - 1;
            const int q = KIND == FWD ? neighbour(g, ap, ay, ax, dy, dx)
                                      : neighbour(g, ap, ay, ax, -dy, -dx);
            if (q >= 0) v = a_src[(long long)q * AC + c];
          }
          f.a[j] = v;
        }
      }
    } else {
      // A[m = tap * CIN + ci (+ the row of ones), k = pixel]
      if (VEC) {
        const int p = kt + tid / 32, m = m0 + (tid % 32) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p < g.npix) {
          const int x = p % g.W, y = (p / g.W) % g.H;
          if (m < 9 * CIN) {
            const int tap = m / CIN, ci = m % CIN;
            const int q = neighbour(g, p, y, x, tap / 3 - 1, tap % 3 - 1);
            if (q >= 0)
              v = *reinterpret_cast<const float4*>(a_src + (long long)q * CIN +
                                                   ci);
          } else if (m == 9 * CIN) {
            v.x = 1.f;
          }
        }
        f.a[0] = v.x; f.a[1] = v.y; f.a[2] = v.z; f.a[3] = v.w;
      } else {
        const int m = m0 + tid % BM;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = kt + tid / BM + 2 * j;
          float v = 0.f;
          if (p < g.npix) {
            const int x = p % g.W, y = (p / g.W) % g.H;
            if (m < 9 * CIN) {
              const int tap = m / CIN, ci = m % CIN;
              const int q = neighbour(g, p, y, x, tap / 3 - 1, tap % 3 - 1);
              if (q >= 0) v = a_src[(long long)q * CIN + ci];
            } else if (m == 9 * CIN) {
              v = 1.f;
            }
          }
          f.a[j] = v;
        }
      }
    }
    if (KIND == DGRAD) {
      // B[k = tap * COUT + co, n = ci] = W[tap][ci][co]
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int idx = tid + j * THREADS;
        const int k = kt + idx % BK, n = n0 + idx / BK;
        const int tap = k / COUT, co = k % COUT;
        f.b[j] = (k < K_LEN && n < CIN)
                     ? b_src[((long long)tap * CIN + n) * COUT + co]
                     : 0.f;
      }
    } else {
      // T1: B[k][n] = W[k][n] (HWIO flattened); T3: B[p][n] = dz[p][n]
      const int k = kt + tid / 32, n = n0 + (tid % 32) * 2;
      const int klen = KIND == FWD ? K_LEN : g.npix;
      float2 v = make_float2(0.f, 0.f);
      if (k < klen && n < COUT)
        v = *reinterpret_cast<const float2*>(b_src + (long long)k * COUT + n);
      f.b[0] = v.x;
      f.b[1] = v.y;
    }
  }

  __device__ void store(const Frag& f, int tid, float (*As)[APAD],
                        float (*Bs)[BPAD]) const {
    if (KIND != WGRAD) {
      if (VEC) {
        const int mm = tid / 2, kq = (tid & 1) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) As[kq + j][mm] = f.a[j];
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) As[tid / BM + 2 * j][tid % BM] = f.a[j];
      }
    } else {
      if (VEC) {
        *reinterpret_cast<float4*>(&As[tid / 32][(tid % 32) * 4]) =
            make_float4(f.a[0], f.a[1], f.a[2], f.a[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) As[tid / BM + 2 * j][tid % BM] = f.a[j];
      }
    }
    if (KIND == DGRAD) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int idx = tid + j * THREADS;
        Bs[idx % BK][idx / BK] = f.b[j];
      }
    } else {
      Bs[tid / 32][(tid % 32) * 2] = f.b[0];
      Bs[tid / 32][(tid % 32) * 2 + 1] = f.b[1];
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

// T1.  alpha == nullptr: the head, y = z.  Else y = PReLU(z), and z is
// written too when z != nullptr.
template <int CIN, int COUT>
__global__ void __launch_bounds__(THREADS)
    fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, const float* __restrict__ alpha,
               float* __restrict__ y, float* __restrict__ z, Geo g) {
  using O = Op<FWD, CIN, COUT>;
  const int tid = threadIdx.x;
  O op{x, w, g, (int)blockIdx.x * BM, (int)blockIdx.y * BN};
  op.init(tid);
  float acc[8][4];
  main_loop(op, 0, O::K_LEN, tid, acc);
  const int tx = tid % 16, ty = tid / 16;
  const int n = op.n0 + ty * 4;
  if (n >= COUT) return;  // COUT % 4 == 0: a thread's 4 columns or none
  const float4 bias = *reinterpret_cast<const float4*>(b + n);
  float4 al = make_float4(0.f, 0.f, 0.f, 0.f);
  if (alpha) al = *reinterpret_cast<const float4*>(alpha + n);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = op.m0 + tile_row(tx, i);
    if (m >= g.npix) continue;
    const float4 zv = make_float4(acc[i][0] + bias.x, acc[i][1] + bias.y,
                                  acc[i][2] + bias.z, acc[i][3] + bias.w);
    float* yo = y + (long long)m * COUT + n;
    if (!alpha) {
      *reinterpret_cast<float4*>(yo) = zv;
      continue;
    }
    // max(z, 0) + alpha * min(z, 0): z above 0, alpha z elsewhere (a NaN
    // stays NaN, as in the reference)
    const float4 yv = make_float4(zv.x > 0.f ? zv.x : al.x * zv.x,
                                  zv.y > 0.f ? zv.y : al.y * zv.y,
                                  zv.z > 0.f ? zv.z : al.z * zv.z,
                                  zv.w > 0.f ? zv.w : al.w * zv.w);
    *reinterpret_cast<float4*>(yo) = yv;
    if (z) *reinterpret_cast<float4*>(z + (long long)m * COUT + n) = zv;
  }
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
  using O = Op<DGRAD, CIN, COUT>;
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

// T3 for a layer CIN -> COUT: split z sums pixels [z kc, (z + 1) kc) and
// writes its partial (9 CIN + 1) x COUT block of [dW; db].
template <int CIN, int COUT>
__global__ void __launch_bounds__(THREADS)
    wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dz,
                 float* __restrict__ part, Geo g, int kc) {
  using O = Op<WGRAD, CIN, COUT>;
  const int tid = threadIdx.x;
  O op{x, dz, g, (int)blockIdx.x * BM, (int)blockIdx.y * BN};
  op.init(tid);
  const int k0 = (int)blockIdx.z * kc;
  const int k1 = min(k0 + kc, g.npix);
  float acc[8][4];
  main_loop(op, k0, k1, tid, acc);
  const int tx = tid % 16, ty = tid / 16;
  const int n = op.n0 + ty * 4;
  if (n >= COUT) return;
  float* out = part + (long long)blockIdx.z * O::M_ROWS * COUT;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = op.m0 + tile_row(tx, i);
    if (m >= O::M_ROWS) continue;
    *reinterpret_cast<float4*>(out + (long long)m * COUT + n) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// out[i] = sum over s of part[s][i], s in order: the fixed-order
// reduction of T3's splits and of T2's d(alpha) block partials.
__global__ void sum_parts_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int parts, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[(long long)p * n + i];
  out[i] = s;
}

cudaError_t sum_parts(const float* part, float* out, int parts, int n,
                      cudaStream_t st) {
  sum_parts_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, parts, n);
  return cudaGetLastError();
}

// Call F<CIN, COUT>::run(args...) for a supported channel pair.
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

template <int CIN, int COUT>
struct Fwd {
  static cudaError_t run(const float* x, const float* w, const float* b,
                         const float* alpha, float* y, float* z, Geo g,
                         cudaStream_t st) {
    dim3 grid((g.npix + BM - 1) / BM, (COUT + BN - 1) / BN);
    fwd_kernel<CIN, COUT><<<grid, THREADS, 0, st>>>(x, w, b, alpha, y, z, g);
    return cudaGetLastError();
  }
};

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

template <int CIN, int COUT>
struct Wgrad {
  static cudaError_t run(const float* x, const float* dz, float* part,
                         float* dwb, int splits, int kc, Geo g,
                         cudaStream_t st) {
    constexpr int M = 9 * CIN + 1;
    dim3 grid((M + BM - 1) / BM, (COUT + BN - 1) / BN, splits);
    wgrad_kernel<CIN, COUT><<<grid, THREADS, 0, st>>>(x, dz, part, g, kc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return sum_parts(part, dwb, splits, M * COUT, st);
  }
};

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a channel pair it does not take).  The
// wrapper (reve_tpu_torch/kernels/train.py) allocates every output and
// scratch buffer.

extern "C" int reve_conv3x3_fwd_train(const float* x, const float* w,
                                      const float* b, const float* alpha,
                                      float* y, float* z, int B, int H, int W,
                                      int cin, int cout, void* stream) {
  const Geo g{H, W, B * H * W};
  if (g.npix == 0) return (int)cudaSuccess;
  return (int)dispatch<Fwd>(cin, cout, x, w, b, alpha, y, z, g,
                            static_cast<cudaStream_t>(stream));
}

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

extern "C" int reve_conv3x3_wgrad(const float* x, const float* dz,
                                  float* part, float* dwb, int B, int H,
                                  int W, int cin, int cout, int splits,
                                  int kc, void* stream) {
  const Geo g{H, W, B * H * W};
  if (g.npix == 0 || kc % BK) return (int)cudaErrorInvalidValue;
  return (int)dispatch<Wgrad>(cin, cout, x, dz, part, dwb, splits, kc, g,
                              static_cast<cudaStream_t>(stream));
}
