// Onebit sign codec for Hopper (sm_90a): pack and the fused unpack-sum.
//
// Replaces byteps_tpu/ops/onebit_kernels.py:_pack_kernel (via _pack_pallas),
// :_make_unpack_sum_kernel (via _unpack_sum_pallas, K <= 32 workers) and
// :_make_unpack_sum_grid_kernel (the same call, K > 32).
// Wire layout (the reference's, kept bit for bit): n f32 values, padded
// with zeros to 32 * L, are viewed as (32, L); bit k of word j is
// x[k * L + j] >= 0. So padding packs as 1, -0.0 as 1 and NaN as 0.
// Words are 32-bit; the Python side holds them as int32 with the uint32
// bits.
//
// pack: one thread per word j reads x[k * L + j] for k = 0..31 (each k a
// coalesced row across the warp, all 32 loads in flight) and writes one
// word. Elements past n read as 0.0, so the caller never pads.
//
// unpack_sum: one thread per output element e = k * L + j < n folds the K
// payloads in order r = 0..K-1 from 0.0f: acc = acc + (bit ? s_r : -s_r),
// the reference's _rows_unpack_acc sum, term for term, so the result is
// the plain version's bit for bit. A warp reads 32 consecutive words of a
// row (coalesced); each word is read again by the 32 threads of its bit
// rows, from cache.
//
// unpack_sum_grid (K > 32): the same thread layout, the reference grid
// kernel's order of adds. The K rows, padded to a multiple of 8 with
// zero-scale rows (which add -0.0), fold in blocks of 8 rows, each block
// from 0.0f; the output is block 0, then out + block b in block order.
//
// What bounds them: bytes. A 1,024,000-element chunk (the default
// 4,096,000-byte partition) moves 4 MB of f32 and 128 KB of words each
// way, about 1.3 us at 3.35 TB/s; at that size a launch costs about as
// much as the transfer.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGridRows = 8;      // the reference grid kernel's row block

__global__ void __launch_bounds__(kThreads)
pack_kernel(const float* __restrict__ x, uint32_t* __restrict__ words,
            long long n, int L) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= L) return;
  float v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const long long e = (long long)k * L + j;
    v[k] = e < n ? x[e] : 0.f;
  }
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) w |= (uint32_t)(v[k] >= 0.f) << k;
  words[j] = w;
}

__global__ void __launch_bounds__(kThreads)
unpack_sum_kernel(const uint32_t* __restrict__ words,
                  const float* __restrict__ scales, float* __restrict__ out,
                  int K, int L, long long n) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const int k = (int)(e / L);
  const int j = (int)(e - (long long)k * L);
  float acc = 0.f;
  for (int r = 0; r < K; ++r) {
    const float s = scales[r];
    const uint32_t bit = (words[(long long)r * L + j] >> k) & 1u;
    acc = __fadd_rn(acc, bit ? s : -s);
  }
  out[e] = acc;
}

__global__ void __launch_bounds__(kThreads)
unpack_sum_grid_kernel(const uint32_t* __restrict__ words,
                       const float* __restrict__ scales,
                       float* __restrict__ out, int K, int L, long long n) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const int k = (int)(e / L);
  const int j = (int)(e - (long long)k * L);
  float acc = 0.f;
  for (int b = 0; b < K; b += kGridRows) {
    float part = 0.f;
#pragma unroll
    for (int r = b; r < b + kGridRows; ++r) {
      const float s = r < K ? scales[r] : 0.f;
      const uint32_t bit =
          r < K ? (words[(long long)r * L + j] >> k) & 1u : 0u;
      part = __fadd_rn(part, bit ? s : -s);
    }
    acc = b == 0 ? part : __fadd_rn(acc, part);
  }
  out[e] = acc;
}

}  // namespace

// x: n f32 on the card; words: L = packed_words(n) 32-bit words. Returns a
// cudaError_t (0 = success).
extern "C" int bps_onebit_pack(const void* x, void* words, long long n, int L,
                               void* stream) {
  if (L == 0) return 0;
  pack_kernel<<<(L + kThreads - 1) / kThreads, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint32_t*>(words), n, L);
  return (int)cudaGetLastError();
}

// words: (K, L) 32-bit words; scales: K f32 on the card; out: n f32, the
// first n elements of the (32, L) sum. Returns a cudaError_t.
extern "C" int bps_onebit_unpack_sum(const void* words, const void* scales,
                                     void* out, int K, int L, long long n,
                                     void* stream) {
  if (n == 0) return 0;
  unpack_sum_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(scales),
      static_cast<float*>(out), K, L, n);
  return (int)cudaGetLastError();
}

// The same contract for K > 32 payloads, in the grid kernel's order.
extern "C" int bps_onebit_unpack_sum_grid(const void* words,
                                          const void* scales, void* out,
                                          int K, int L, long long n,
                                          void* stream) {
  if (n == 0) return 0;
  unpack_sum_grid_kernel<<<(unsigned)((n + kThreads - 1) / kThreads),
                           kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(scales),
      static_cast<float*>(out), K, L, n);
  return (int)cudaGetLastError();
}

extern "C" const char* bps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
