// Segmented LoRA delta for Hopper (sm_90a): every packed row's own
// low-rank delta, out[r] = (x[r] @ A[slots[r]]) @ B[slots[r]].
//
// Replaces byteps_tpu/ops/segmented_lora.py:_delta_pallas (the kernel body
// at :87, pallas_call :107; via segmented_lora_delta :114). Its arithmetic
// is the Pallas body's: x upcast to f32, A and B f32, u = x @ A kept in f32,
// out = (u @ B) cast to x's dtype. Slot 0 of a pool is all zeros, so a
// finite row on slot 0 gets exactly +0.0.
//
// Layout: x (R, S, d_in) bf16 or f32, contiguous; A (n_slots, d_in, rb) and
// B (n_slots, rb, d_out) f32 whose inner two dims are contiguous and whose
// slot stride is passed in (a layer's slice of the pool's (n_slots, L, d_in,
// rb) slab is a strided view; nothing is copied); slots (R,) int32; out
// (R, S, d_out) in x's dtype.
//
// Grid: (d_out tiles of 256, S tiles of 8, R). A block loads its row's slot
// itself (Hopper has no scalar prefetch) and never reads the slab for a slot
// outside [0, n_slots): the wrapper refuses those, and the kernel writes NaN.
//   phase 1: for each of the tile's rows s, u[s, j] = sum_k x[s, k] A[k, j].
//     Thread t takes k = t, t + 256, ... in order (one fma chain per j;
//     x read coalesced, A's rows of rb floats contiguous across the warp),
//     then a fixed xor-shuffle tree within each warp and the 8 warp partials
//     added in warp order. u stays in shared memory.
//   phase 2: thread t owns column n = tile * 256 + t: it holds B[:, n] in
//     registers (coalesced rows of B) and sums j = 0 .. rb-1 in order.
// Batch invariance: each u and each output element is summed in an order
// that depends only on d_in and rb, never on R, S, the row's index, its slot
// or the tile that holds it, and no atomics are used. So a row computed in a
// packed decode batch, in a prefill chunk or in a solo step comes out bit
// for bit the same, which is what keeps pooled tokens equal to solo ones.
//
// What bounds it: bytes. At the packed decode shape (R = 16, S = 1,
// 1024 -> 8 -> 1024, bf16) it reads 32 KB of x and up to 16 x 64 KB of
// slabs and writes 32 KB, about 1.1 MB or 0.33 us at 3.35 TB/s, for 0.5
// MFLOP; at a few us a launch it is launch- and latency-bound. Each block
// of a row recomputes u (d_out / 256 times, from L2); grouping rows by
// slot and mma.sync for S >= 16 are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSTile = 8;       // rows of S per block
constexpr int kNTile = kThreads;  // output columns per block, one a thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int RB>
__global__ void __launch_bounds__(kThreads)
segmented_lora_kernel(const T* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ b,
                      const int* __restrict__ slots, T* __restrict__ out,
                      int S, int d_in, int rb, int d_out, int n_slots,
                      long long a_stride, long long b_stride) {
  __shared__ float red[kWarps][RB];
  __shared__ float u[kSTile][RB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = blockIdx.z;
  const int s0 = blockIdx.y * kSTile;
  const int rows = min(kSTile, S - s0);
  const int n = blockIdx.x * kNTile + tid;
  T* o = out + ((long long)r * S + s0) * d_out;
  const int slot = slots[r];
  if (slot < 0 || slot >= n_slots) {
    if (n < d_out)
      for (int s = 0; s < rows; ++s)
        o[(long long)s * d_out + n] = from_f32<T>(nanf(""));
    return;
  }
  const float* A = a + slot * a_stride;
  const float* B = b + slot * b_stride;
  const T* xr = x + ((long long)r * S + s0) * d_in;

  for (int s = 0; s < rows; ++s) {
    float acc[RB];
#pragma unroll
    for (int j = 0; j < RB; ++j) acc[j] = 0.f;
    for (int k = tid; k < d_in; k += kThreads) {
      const float xv = to_f32(xr[(long long)s * d_in + k]);
      const float* ak = A + (long long)k * rb;
#pragma unroll
      for (int j = 0; j < RB; ++j)
        if (j < rb) acc[j] = fmaf(xv, ak[j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      if (j < rb) {                 // rb is the same for the whole block
        float v = acc[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) red[warp][j] = v;
      }
    }
    __syncthreads();
    if (tid < rb) {
      float v = red[0][tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += red[w][tid];
      u[s][tid] = v;
    }
    __syncthreads();
  }

  if (n >= d_out) return;           // no barrier past this point
  float bv[RB];
#pragma unroll
  for (int j = 0; j < RB; ++j)
    bv[j] = j < rb ? B[(long long)j * d_out + n] : 0.f;
  for (int s = 0; s < rows; ++s) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < RB; ++j)
      if (j < rb) acc = fmaf(u[s][j], bv[j], acc);
    o[(long long)s * d_out + n] = from_f32<T>(acc);
  }
}

template <typename T, int RB>
int launch(const void* x, const void* a, const void* b, const void* slots,
           void* out, int R, int S, int d_in, int rb, int d_out, int n_slots,
           long long a_stride, long long b_stride, cudaStream_t stream) {
  const dim3 grid((d_out + kNTile - 1) / kNTile, (S + kSTile - 1) / kSTile,
                  R);
  segmented_lora_kernel<T, RB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const int*>(slots),
      static_cast<T*>(out), S, d_in, rb, d_out, n_slots, a_stride, b_stride);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* a, const void* b, const void* slots,
             void* out, int R, int S, int d_in, int rb, int d_out,
             int n_slots, long long a_stride, long long b_stride,
             cudaStream_t stream) {
  if (rb <= 8)
    return launch<T, 8>(x, a, b, slots, out, R, S, d_in, rb, d_out, n_slots,
                        a_stride, b_stride, stream);
  if (rb <= 16)
    return launch<T, 16>(x, a, b, slots, out, R, S, d_in, rb, d_out, n_slots,
                         a_stride, b_stride, stream);
  if (rb <= 32)
    return launch<T, 32>(x, a, b, slots, out, R, S, d_in, rb, d_out, n_slots,
                         a_stride, b_stride, stream);
  return launch<T, 64>(x, a, b, slots, out, R, S, d_in, rb, d_out, n_slots,
                       a_stride, b_stride, stream);
}

}  // namespace

// x (R, S, d_in) bf16 (is_bf16 = 1) or f32; a, b: the slabs' slot-0
// pointers, a_stride / b_stride their slot strides in floats; slots (R,)
// int32; out (R, S, d_out) in x's dtype; 1 <= rb <= 64. All on the card.
// Returns a cudaError_t (0 = success; cudaErrorInvalidValue for rb > 64).
extern "C" int bps_segmented_lora(const void* x, const void* a, const void* b,
                                  const void* slots, void* out, int R, int S,
                                  int d_in, int rb, int d_out, int n_slots,
                                  long long a_stride, long long b_stride,
                                  int is_bf16, void* stream) {
  if (rb < 1 || rb > 64) return (int)cudaErrorInvalidValue;
  if (R == 0 || S == 0 || d_out == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(x, a, b, slots, out, R, S, d_in, rb,
                                   d_out, n_slots, a_stride, b_stride, st);
  return dispatch<float>(x, a, b, slots, out, R, S, d_in, rb, d_out, n_slots,
                         a_stride, b_stride, st);
}

extern "C" const char* bps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
