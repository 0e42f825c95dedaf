// Shared by the training convs' two sources, conv3x3_train.cu (T2) and
// conv3x3_train_tc.cu (T1, T3): the channel pairs they take and the
// fixed-order sum of partials that both T2's d(alpha) and T3's splits end
// in.
#pragma once

#include "common.cuh"

namespace reve {
namespace train {

// out[i] = sum over p < parts of part[p][i], p in order: a sum of block or
// split partials in an order set by the shapes alone (no float atomics),
// so a training step repeats bit for bit.
__global__ void __launch_bounds__(256)
    sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                     int parts, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s = __fadd_rn(s, part[(long long)p * n + i]);
  out[i] = s;
}

inline cudaError_t sum_parts(const float* part, float* out, int parts, int n,
                             cudaStream_t st) {
  sum_parts_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, parts, n);
  return cudaGetLastError();
}

// Call F<CIN, COUT>::run(args...) for a channel pair the training convs
// take: Cin 3, 64, 128 x Cout 48, 64, 128; cudaErrorInvalidValue for any
// other.
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

}  // namespace train
}  // namespace reve
