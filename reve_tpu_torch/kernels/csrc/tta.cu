// K6: the TTA inverse-dihedral accumulate (sm_90a, plain C interface).
//
// Replaces reve_tpu/pipeline/engine.py::_tta_acc_device (:189-201) and
// ::_tta_mean_device (:204-209).  For the model output y (u8, (B, H', W',
// 3)) of the forward transform (k, flip) -- rot90 by k on the spatial
// axes, then a horizontal flip -- it undoes the flip, rotates by -k, widens
// to 16 bits and adds the term to the accumulator acc ((B, Ho, Wo, 3),
// (H', W') = (Wo, Ho) for odd k).  Eight u8 terms sum to at most 2040, so
// the sum is exact; the accumulator is stored as int16 (the same bits as
// the reference's uint16 for every value it can hold).  Three forms, the
// transform and the form template parameters:
//   FIRST   acc = term                (acc is not read)
//   MIDDLE  acc += term
//   LAST    out = u8((acc + term + 4) >> 3), round half up (acc is not
//           written): the ensemble's mean, which the host copy reads.
//
// Bound: bytes.  Per output value FIRST moves 3 B (y in, acc out), MIDDLE
// 5 B, LAST 4 B; at 4 frames of 1080p x4 (398.1 M values, 3.35 TB/s)
// 0.356, 0.594 and 0.475 ms.  There is no arithmetic to speak of.
//
// Design (simple and right): an odd k is a transpose of 3-byte pixels, so
// each block stages the T x T pixels of y that its T x T output tile
// reads through shared memory.  The y rectangle is read row by row and
// the acc/out tile written row by row, both in consecutive bytes across
// consecutive threads, for every (k, flip).  A block is 3T x 2 threads:
// thread (cb, ry) owns byte column cb of a tile row (pixel cb / 3,
// channel cb % 3) and rows ry, ry + 2, ..., whose acc values it reads
// all before it writes any: 16 loads in flight a thread (MIDDLE at k = 2
// took 1.00 ms at 2 rows a pass, 1.17 at 4 and 1.08 at 1 on an H100;
// `python -m reve_tpu_torch.scripts.perf_conv_tc_parts --sources
// tta.cu`).  Ragged tiles at the right and bottom edges are masked.  A
// transform maps a rectangle onto a rectangle, so the y rectangle is
// spanned by the images of the tile's two corners (`source`, whose copy
// in tests/test_torch_tta.py the CPU tests hold against torch.rot90/flip).

#include "common.cuh"

namespace {

constexpr int T = 32;          // output tile side, pixels
constexpr int ROW_BYTES = 3 * T;
constexpr int ROWS_PER_PASS = 2;
constexpr int THREADS = ROW_BYTES * ROWS_PER_PASS;  // 192
constexpr int ROWS_PER_THREAD = T / ROWS_PER_PASS;
constexpr int FIRST = 0, MIDDLE = 1, LAST = 2;

// Output pixel (i, j) of the (Ho, Wo) frame reads y pixel (p, q): the
// inverse of rot90(., K) followed by a flip of the width axis.
template <int K, bool FLIP>
__device__ __forceinline__ void source(int i, int j, int Ho, int Wo, int& p,
                                       int& q) {
  int zq;
  if (K == 0) {
    p = i;
    zq = j;
  } else if (K == 1) {
    p = Wo - 1 - j;
    zq = i;
  } else if (K == 2) {
    p = Ho - 1 - i;
    zq = Wo - 1 - j;
  } else {
    p = j;
    zq = Ho - 1 - i;
  }
  const int Wy = (K & 1) ? Ho : Wo;
  q = FLIP ? Wy - 1 - zq : zq;
}

template <int K, bool FLIP, int FORM>
__global__ void __launch_bounds__(THREADS)
    tta_accumulate_kernel(const uint8_t* __restrict__ y,
                          int16_t* __restrict__ acc,
                          uint8_t* __restrict__ out, int Ho, int Wo) {
  __shared__ uint8_t stage[T][ROW_BYTES + 4];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * T, j0 = blockIdx.x * T;
  const int i1 = min(i0 + T, Ho), j1 = min(j0 + T, Wo);
  const int Hy = (K & 1) ? Wo : Ho, Wy = (K & 1) ? Ho : Wo;
  int pa, qa, pb, qb;
  source<K, FLIP>(i0, j0, Ho, Wo, pa, qa);
  source<K, FLIP>(i1 - 1, j1 - 1, Ho, Wo, pb, qb);
  const int p0 = min(pa, pb), q0 = min(qa, qb);
  const int rect_rows = max(pa, pb) - p0 + 1;
  const int rect_bytes = 3 * (max(qa, qb) - q0 + 1);
  const int cb = threadIdx.x % ROW_BYTES, ry = threadIdx.x / ROW_BYTES;

  const uint8_t* ysrc = y + ((size_t)b * Hy + p0) * Wy * 3 + (size_t)q0 * 3;
  if (cb < rect_bytes) {
    for (int r = ry; r < rect_rows; r += ROWS_PER_PASS)
      stage[r][cb] = ysrc[(size_t)r * Wy * 3 + cb];
  }
  __syncthreads();

  const int tile_bytes = 3 * (j1 - j0), tile_rows = i1 - i0;
  if (cb >= tile_bytes) return;
  const int jj = cb / 3, ch = cb - 3 * jj;
  const size_t base = ((size_t)b * Ho + i0) * Wo * 3 + (size_t)j0 * 3 + cb;
  const size_t row = (size_t)Wo * 3 * ROWS_PER_PASS;
  // all of the thread's acc reads before any of its writes: the reads
  // stay in flight together (a write through acc would otherwise order
  // the next row's read after it)
  int v[ROWS_PER_THREAD];
#pragma unroll
  for (int n = 0; n < ROWS_PER_THREAD; ++n) {
    const int r = ry + n * ROWS_PER_PASS;
    if (r < tile_rows) {
      int p, q;
      source<K, FLIP>(i0 + r, j0 + jj, Ho, Wo, p, q);
      v[n] = stage[p - p0][3 * (q - q0) + ch];
      if (FORM != FIRST) v[n] += acc[base + (size_t)ry * Wo * 3 + n * row];
    }
  }
#pragma unroll
  for (int n = 0; n < ROWS_PER_THREAD; ++n) {
    const int r = ry + n * ROWS_PER_PASS;
    if (r < tile_rows) {
      const size_t o = base + (size_t)ry * Wo * 3 + n * row;
      if (FORM == LAST)
        out[o] = (uint8_t)((v[n] + 4) >> 3);
      else
        acc[o] = (int16_t)v[n];
    }
  }
}

using Launch = void (*)(dim3, cudaStream_t, const uint8_t*, int16_t*,
                        uint8_t*, int, int);

template <int K, bool FLIP, int FORM>
void launch(dim3 grid, cudaStream_t stream, const uint8_t* y, int16_t* acc,
            uint8_t* out, int Ho, int Wo) {
  tta_accumulate_kernel<K, FLIP, FORM>
      <<<grid, THREADS, 0, stream>>>(y, acc, out, Ho, Wo);
}

#define REVE_TTA_FORMS(K, F) \
  { launch<K, F, FIRST>, launch<K, F, MIDDLE>, launch<K, F, LAST> }
#define REVE_TTA_FLIPS(K) \
  { REVE_TTA_FORMS(K, false), REVE_TTA_FORMS(K, true) }

const Launch kLaunch[4][2][3] = {REVE_TTA_FLIPS(0), REVE_TTA_FLIPS(1),
                                 REVE_TTA_FLIPS(2), REVE_TTA_FLIPS(3)};

}  // namespace

// y: (B, Ho, Wo, 3) u8 for even k, (B, Wo, Ho, 3) for odd k; acc: (B, Ho,
// Wo, 3) int16; out: (B, Ho, Wo, 3) u8 (written by the LAST form only;
// the others may pass null).  k in 0..3, flip 0/1, form 0 FIRST, 1 MIDDLE,
// 2 LAST.  Returns the launch's cudaError_t.
extern "C" int reve_tta_accumulate(const void* y, void* acc, void* out,
                                   int B, int Ho, int Wo, int k, int flip,
                                   int form, void* stream) {
  if (B < 1 || Ho < 1 || Wo < 1 || B > 65535 || (Ho + T - 1) / T > 65535 ||
      k < 0 || k > 3 || flip < 0 || flip > 1 || form < FIRST ||
      form > LAST)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Wo + T - 1) / T, (Ho + T - 1) / T, B);
  kLaunch[k][flip][form](grid, static_cast<cudaStream_t>(stream),
                         static_cast<const uint8_t*>(y),
                         static_cast<int16_t*>(acc),
                         static_cast<uint8_t*>(out), Ho, Wo);
  return (int)cudaGetLastError();
}
