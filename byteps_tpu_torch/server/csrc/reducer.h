// Vectorized summation kernels for the aggregation tier.
//
// Reference analog: byteps/common/cpu_reducer.{h,cc} (AVX+OpenMP sum used by
// servers and cross-PCIe-switch reduce). Here plain C++ loops compiled with
// -O3 -march=native -ffast-math: the compiler emits the AVX; threading comes
// from the server's engine pool (parallel across keys), with a split helper
// for very large single keys.
#pragma once

#include <cstdint>

namespace bps {

void reduce_sum_f32(float* dst, const float* src, int64_t n);
// dst += src for a slice [lo, hi) — lets callers parallelize one huge key.
void reduce_sum_f32_range(float* dst, const float* src, int64_t lo,
                          int64_t hi);

}  // namespace bps

extern "C" {
// exposed for Python-side golden tests of the kernel
void bps_reduce_sum_f32(float* dst, const float* src, int64_t n);
}
