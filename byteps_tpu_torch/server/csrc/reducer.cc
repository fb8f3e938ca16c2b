#include "reducer.h"

namespace bps {

void reduce_sum_f32_range(float* dst, const float* src, int64_t lo,
                          int64_t hi) {
  // restrict-qualified simple loop: auto-vectorizes to AVX2/AVX-512 at -O3
  float* __restrict__ d = dst + lo;
  const float* __restrict__ s = src + lo;
  const int64_t n = hi - lo;
  for (int64_t i = 0; i < n; ++i) d[i] += s[i];
}

void reduce_sum_f32(float* dst, const float* src, int64_t n) {
  reduce_sum_f32_range(dst, src, 0, n);
}

}  // namespace bps

extern "C" void bps_reduce_sum_f32(float* dst, const float* src, int64_t n) {
  bps::reduce_sum_f32(dst, src, n);
}
