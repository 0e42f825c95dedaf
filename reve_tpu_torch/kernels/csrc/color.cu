// K9: RGB u8 -> YUV 4:2:0 codes (sm_90a, plain C interface).
//
// Replaces reve_tpu/ops/color.py::rgb_to_yuv420 (:142-150), the
// reference's device conversion of the model's output to the encoder's
// planes (applied to u8 / 255, as the writers' host conversion
// ops/color_np.py::rgb_to_yuv420_np computes it).  No Pallas kernel: the
// reference leaves it to XLA inside its inference graph.  The input is
// the engine's u8 output (B, H, W, 3), H and W even; the outputs are the
// planes Y (B, H, W) and U, V (B, H/2, W/2), u8 codes at 8 bits or the
// uint16 codes at 10.  The matrix (BT.601, BT.709) and the range
// (limited, full) come in as float32 constants the wrapper rounds from
// the reference's Python doubles, so one kernel per code type covers the
// 8 forms.
//
// Exactness: every float op is one IEEE op rounded to nearest, in the
// reference's order (u8 / 255, (kr r + kg g) + kb b, (b - y) / cu,
// ((a + b) + (c + d)) / 4, c s + o, round half to even, clip), written
// with the _rn intrinsics, which nvcc and ptxas never contract into an
// FMA.  The codes are the plain version's bit for bit.  The divisions are
// correctly rounded (div.rn.f32; ptxas expands it with FFMAs of its own,
// the same under -fmad=false: kernels.color.contraction_faults compares
// the two builds).  u8 / 255 takes one of 256 values: each block computes
// them once into shared memory.
//
// Bound: bytes.  3 B read and 1.5 B (8-bit) or 3 B (10-bit) written a
// pixel: a batch of 4 frames of 7680 x 4320 moves 597 MB (0.178 ms at
// 3.35 TB/s) or 796 MB (0.238 ms).  About 40 float ops a pixel, two of
// them divisions: far below the float32 rate's share of that time.
//
// Design (simple and right): one thread takes 16 pixels of a row pair
// (8 quads: 4 Y codes, one U and one V each) with six 16-B loads and
// 16-B (8-B) stores of its Y (U, V) codes, adjacent threads on adjacent
// bytes; rows whose width is not a multiple of 16 take a thread a quad
// with byte loads.  The arithmetic is one function for both.

#include "common.cuh"

namespace {

struct Coeffs {
  float kr, kg, kb;  // luma weights
  float cu, cv;      // chroma divisors f32(2 (1 - kb)), f32(2 (1 - kr))
  float ys, yo;      // luma code before rounding: y * ys + yo
  float cs, co;      // chroma code before rounding: c * cs + co
  int hi;            // the largest code
};

constexpr int THREADS = 128;
constexpr int VEC_PX = 16;  // pixels of a row a vector-form thread takes

__device__ __forceinline__ int to_code(float v, float s, float o, int hi) {
  // __float2int_rn rounds half to even, as numpy's round does
  return min(max(__float2int_rn(__fadd_rn(__fmul_rn(v, s), o)), 0), hi);
}

// One 2 x 2 quad: t (upper row) and d (lower row) each hold the RGB
// bytes of the quad's two pixels.  Writes the four Y codes (y[0..1] the
// upper row) and the U and V codes.
__device__ __forceinline__ void quad(const Coeffs& k, const float* unit,
                                     const uint32_t t[6],
                                     const uint32_t d[6], int y[4], int& uc,
                                     int& vc) {
  float u[4], v[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const uint32_t* px = (p < 2 ? t : d) + 3 * (p & 1);
    const float r = unit[px[0]], g = unit[px[1]], b = unit[px[2]];
    const float yv = __fadd_rn(__fadd_rn(__fmul_rn(k.kr, r),
                                         __fmul_rn(k.kg, g)),
                               __fmul_rn(k.kb, b));
    u[p] = __fdiv_rn(__fsub_rn(b, yv), k.cu);
    v[p] = __fdiv_rn(__fsub_rn(r, yv), k.cv);
    y[p] = to_code(yv, k.ys, k.yo, k.hi);
  }
  // x / 4 and x * 0.25 are the same correctly rounded value
  const float um = __fmul_rn(__fadd_rn(__fadd_rn(u[0], u[1]),
                                       __fadd_rn(u[2], u[3])), 0.25f);
  const float vm = __fmul_rn(__fadd_rn(__fadd_rn(v[0], v[1]),
                                       __fadd_rn(v[2], v[3])), 0.25f);
  uc = to_code(um, k.cs, k.co, k.hi);
  vc = to_code(vm, k.cs, k.co, k.hi);
}

__device__ __forceinline__ void fill_unit(float* unit) {
  for (int c = threadIdx.x; c < 256; c += blockDim.x)
    unit[c] = __fdiv_rn((float)c, 255.f);
  __syncthreads();
}

// Codes packed little-endian into 32-bit words: 4 u8 or 2 u16 a word.
template <typename T, int N>
__device__ __forceinline__ void pack(const int* c, uint32_t* w) {
  constexpr int PER = 4 / sizeof(T);
#pragma unroll
  for (int i = 0; i < N / PER; ++i) {
    uint32_t x = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      x |= (uint32_t)c[i * PER + j] << (8 * sizeof(T) * j);
    w[i] = x;
  }
}

// NW words to dst, 16 B at a time (8 B for two words).
template <int NW>
__device__ __forceinline__ void store_words(void* dst, const uint32_t* w) {
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NW / 4; ++i)
      reinterpret_cast<uint4*>(dst)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  } else {
    static_assert(NW == 2, "two words or a multiple of four");
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  }
}

// A thread: VEC_PX pixels of quad row q (rows 2i, 2i + 1 of frame b).
// W % 16 == 0 and every pointer 16-B aligned.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    rgb_to_yuv420_vec_kernel(const uint8_t* __restrict__ x,
                             T* __restrict__ yp, T* __restrict__ up,
                             T* __restrict__ vp, int rows, int W,
                             Coeffs k) {
  __shared__ float unit[256];
  fill_unit(unit);
  const int units = W / VEC_PX;
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= units) return;
  constexpr int Q = VEC_PX / 2;  // quads a thread takes
  for (int q = blockIdx.y; q < rows; q += gridDim.y) {
    // q = b * H/2 + i: the upper row is row 2q of the (B * H, W) image
    const uint8_t* top = x + (size_t)(2 * q) * W * 3 + (size_t)col * 48;
    const uint8_t* bot = top + (size_t)W * 3;
    uint32_t a[12], c[12];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const uint4 ta = __ldg(reinterpret_cast<const uint4*>(top) + i);
      const uint4 tc = __ldg(reinterpret_cast<const uint4*>(bot) + i);
      a[4 * i] = ta.x, a[4 * i + 1] = ta.y, a[4 * i + 2] = ta.z,
      a[4 * i + 3] = ta.w;
      c[4 * i] = tc.x, c[4 * i + 1] = tc.y, c[4 * i + 2] = tc.z,
      c[4 * i + 3] = tc.w;
    }
    int y0[VEC_PX], y1[VEC_PX], uc[Q], vc[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      uint32_t t[6], d[6];
#pragma unroll
      for (int n = 0; n < 6; ++n) {
        const int byte = 6 * j + n;
        t[n] = (a[byte >> 2] >> (8 * (byte & 3))) & 0xFFu;
        d[n] = (c[byte >> 2] >> (8 * (byte & 3))) & 0xFFu;
      }
      int yq[4];
      quad(k, unit, t, d, yq, uc[j], vc[j]);
      y0[2 * j] = yq[0], y0[2 * j + 1] = yq[1];
      y1[2 * j] = yq[2], y1[2 * j + 1] = yq[3];
    }
    constexpr int PER = 4 / sizeof(T);
    uint32_t w[VEC_PX / PER];
    T* yrow = yp + (size_t)(2 * q) * W + (size_t)col * VEC_PX;
    pack<T, VEC_PX>(y0, w);
    store_words<VEC_PX / PER>(yrow, w);
    pack<T, VEC_PX>(y1, w);
    store_words<VEC_PX / PER>(yrow + W, w);
    const size_t co = (size_t)q * (W / 2) + (size_t)col * Q;
    pack<T, Q>(uc, w);
    store_words<Q / PER>(up + co, w);
    pack<T, Q>(vc, w);
    store_words<Q / PER>(vp + co, w);
  }
}

// A thread: one quad, byte loads (any even W).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    rgb_to_yuv420_quad_kernel(const uint8_t* __restrict__ x,
                              T* __restrict__ yp, T* __restrict__ up,
                              T* __restrict__ vp, int rows, int W,
                              Coeffs k) {
  __shared__ float unit[256];
  fill_unit(unit);
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= W / 2) return;
  for (int q = blockIdx.y; q < rows; q += gridDim.y) {
    const uint8_t* top = x + (size_t)(2 * q) * W * 3 + (size_t)j * 6;
    const uint8_t* bot = top + (size_t)W * 3;
    uint32_t t[6], d[6];
#pragma unroll
    for (int n = 0; n < 6; ++n) t[n] = __ldg(top + n), d[n] = __ldg(bot + n);
    int yq[4], uc, vc;
    quad(k, unit, t, d, yq, uc, vc);
    T* yrow = yp + (size_t)(2 * q) * W + 2 * j;
    yrow[0] = (T)yq[0], yrow[1] = (T)yq[1];
    yrow[W] = (T)yq[2], yrow[W + 1] = (T)yq[3];
    const size_t co = (size_t)q * (W / 2) + j;
    up[co] = (T)uc;
    vp[co] = (T)vc;
  }
}

template <typename T>
cudaError_t launch(bool vec, const void* x, void* y, void* u, void* v,
                   int rows, int W, const Coeffs& k, cudaStream_t stream) {
  const int per_row = vec ? W / VEC_PX : W / 2;
  const dim3 grid((per_row + THREADS - 1) / THREADS,
                  rows < 65535 ? rows : 65535);
  if (vec)
    rgb_to_yuv420_vec_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const uint8_t*>(x), static_cast<T*>(y),
        static_cast<T*>(u), static_cast<T*>(v), rows, W, k);
  else
    rgb_to_yuv420_quad_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const uint8_t*>(x), static_cast<T*>(y),
        static_cast<T*>(u), static_cast<T*>(v), rows, W, k);
  return cudaGetLastError();
}

}  // namespace

// x: (B, H, W, 3) u8; y: (B, H, W), u, v: (B, H/2, W/2) of `bits` codes
// (8: u8, 10: u16).  vec 1 takes the vector form (W % 16 == 0, every
// pointer 16-B aligned; the wrapper decides).  Returns the launch's
// cudaError_t.
extern "C" int reve_rgb_to_yuv420_u8(const void* x, void* y, void* u,
                                     void* v, int B, int H, int W, int bits,
                                     int vec, float kr, float kg, float kb,
                                     float cu, float cv, float ys, float yo,
                                     float cs, float co, void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 ||
      (vec && W % VEC_PX) || (bits != 8 && bits != 10) ||
      (long long)B * H * W * 3 >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  const Coeffs k{kr, kg, kb, cu, cv, ys, yo, cs, co, (1 << bits) - 1};
  const int rows = B * (H / 2);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(bits == 8
                   ? launch<uint8_t>(vec, x, y, u, v, rows, W, k, s)
                   : launch<uint16_t>(vec, x, y, u, v, rows, W, k, s));
}
