// Shared pieces of the port's attention kernels (flash_fwd.cu,
// flash_decode.cu, flash_bwd.cu): dtype conversion, staging of key/value
// tiles in shared memory, the per-warp online-softmax step over one tile,
// and the tensor-core pieces of the bf16 paths.
//
// Numerics follow byteps_tpu/ops/flash_attention.py:_fwd_kernel: s = (q.k)
// * scale accumulated in f32, masked lanes carry -1e30, the running
// (m, l, acc) state is rescaled by exp(m_prev - m_new), and a row that
// never sees a live key ends with o = 0, lse = -1e30. In the FMA paths p
// stays f32 for the PV product (the TPU kernel rounded it to the input
// dtype for its MXU; the plain PyTorch twin never did); the bf16
// tensor-core forward rounds it, as the TPU kernel did.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cluster.cuh"

namespace bps {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileKeys = 32;  // keys per shared tile: one per lane

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Row stride of a shared key/value tile: odd, so lane j reading row j
// at column d hits bank (j * ld + d) % 32, a different bank per lane.
__host__ __device__ __forceinline__ int tile_ld(int D) { return D | 1; }

// The f32 value of one stored element: dense entries widen; int8
// entries dequantize through their row's scale, rounded to the model
// dtype T first (the reference's _cache_read rule), then widen.
template <typename T, typename C>
__device__ __forceinline__ float widen(C x, float s) {
  if constexpr (std::is_same<C, int8_t>::value) {
    return to_f32<T>(from_f32<T>(static_cast<float>(x) * s));
  } else {
    return to_f32(x);
  }
}

// Stage rows [0, n) of P alike (rows x D) slabs (k and v, or q alone)
// into shared f32 tiles of row stride ld. Row r of slab p starts at
// src[p] + r * stride elements; int8 slabs pass one f32 scale per row
// at scale[p] + r * sstride (dense slabs pass nullptr). NT threads take
// part, tid in [0, NT). Where the rows are 16-byte aligned the copy
// moves 16-byte vectors, 8 per thread across the slabs issued before
// any is used, so the P slabs of a tile cost about one memory round trip
// together instead of one per element.
template <typename T, typename C, int NT, int P>
__device__ __forceinline__ void stage_rows(float* const (&dst)[P], int ld,
                                           const C* const (&src)[P],
                                           int64_t stride,
                                           const float* const (&scale)[P],
                                           int64_t sstride, int n, int D,
                                           int tid) {
  constexpr int E = 16 / sizeof(C);
  constexpr int U = 8 / P;  // vectors in flight per slab per thread
  bool vec = D % E == 0 && stride % E == 0;
#pragma unroll
  for (int p = 0; p < P; ++p)
    vec = vec && (reinterpret_cast<uintptr_t>(src[p]) & 15) == 0;
  if (vec) {
    const int cpr = D / E, total = n * cpr;
    for (int base = tid; base < total; base += NT * U) {
      uint4 buf[P][U];
      float sc[P][U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = base + u * NT;
        if (c < total) {
          const int r = c / cpr;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            buf[p][u] = *reinterpret_cast<const uint4*>(
                src[p] + r * stride + (c - r * cpr) * E);
            sc[p][u] = scale[p] != nullptr ? scale[p][r * sstride] : 1.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = base + u * NT;
        if (c < total) {
          const int r = c / cpr, d0 = (c - r * cpr) * E;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const C* e = reinterpret_cast<const C*>(&buf[p][u]);
#pragma unroll
            for (int i = 0; i < E; ++i)
              dst[p][r * ld + d0 + i] = widen<T, C>(e[i], sc[p][u]);
          }
        }
      }
    }
  } else {
    for (int idx = tid; idx < n * D; idx += NT) {
      const int r = idx / D, d = idx - r * D;
#pragma unroll
      for (int p = 0; p < P; ++p)
        dst[p][r * ld + d] = widen<T, C>(
            src[p][r * stride + d],
            scale[p] != nullptr ? scale[p][r * sstride] : 1.f);
    }
  }
}

// One warp folds a shared tile of keys into the online-softmax state of
// R query rows at once: row r takes the first n_live[r] keys (none when
// n_live[r] <= 0). Lane j scores key j for every row, so the R dot
// products share each load of the key and run as independent chains;
// lane i owns output columns i, i + 32, ... of acc. m and l are the same
// on every lane. A row that takes no key of the tile keeps its state
// bit for bit (alpha = 1, p = 0), so the rows beside it in the warp do
// not change its result. ks/vs: [kTileKeys][ld] f32; qrows: R rows of D
// f32 in shared memory, row r at qrows + r * D.
template <int R, int DMAX>
__device__ __forceinline__ void fold_rows(const float* __restrict__ qrows,
                                          const float* __restrict__ ks,
                                          const float* __restrict__ vs,
                                          int ld, int D, const int (&n_live)[R],
                                          float scale, float (&m)[R],
                                          float (&l)[R],
                                          float (&acc)[R][DMAX / 32]) {
  const int lane = threadIdx.x & 31;
  int n_max = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) n_max = max(n_max, n_live[r]);
  if (n_max <= 0) return;  // warp-uniform
  float dot[R];
#pragma unroll
  for (int r = 0; r < R; ++r) dot[r] = 0.f;
  if (lane < n_max) {
    const float* kr = ks + lane * ld;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < R; ++r) dot[r] = fmaf(qrows[r * D + d], kd, dot[r]);
    }
  }
  // the rows' warp reductions (max, then sum) run side by side, each in
  // the same xor-butterfly order
  float s[R], mx[R], p[R], sum[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    s[r] = lane < n_live[r] ? dot[r] * scale : kNeg;
    mx[r] = s[r];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], o));
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mx[r] = fmaxf(m[r], mx[r]);
    p[r] = (s[r] > 0.5f * kNeg) ? expf(s[r] - mx[r]) : 0.f;
    sum[r] = p[r];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) sum[r] += __shfl_xor_sync(kFull, sum[r], o);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float alpha = expf(m[r] - mx[r]);
    l[r] = l[r] * alpha + sum[r];
#pragma unroll
    for (int i = 0; i < DMAX / 32; ++i) acc[r][i] *= alpha;
    m[r] = mx[r];
  }
#pragma unroll 8
  for (int j = 0; j < n_max; ++j) {
    float pj[R];
#pragma unroll
    for (int r = 0; r < R; ++r) pj[r] = __shfl_sync(kFull, p[r], j);
    const float* vr = vs + j * ld;
#pragma unroll
    for (int i = 0; i < DMAX / 32; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        const float vd = vr[d];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][i] = fmaf(pj[r], vd, acc[r][i]);
      }
    }
  }
}

// --------------------------------------------------------------------------
// Asynchronous copies (flash_fwd.cu's split path, flash_decode.cu); the
// cluster pieces are in cluster.cuh.
// --------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// 16 bytes from src, or 16 zero bytes (nothing read) where `valid` is false
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --------------------------------------------------------------------------
// Pieces of the bf16 tensor-core paths (the wgmma kernels, hopper.cuh).
//
// Accumulator layout of a 16x8 block of a product, lane l = 4g + t:
// c[0], c[1] are row g, columns 2t and 2t + 1; c[2], c[3] the same
// columns of row g + 8. The accumulators of two adjacent 8-column blocks,
// rounded to bf16 and packed in pairs (pack_bf16), are the register A
// operand of one 16-deep step, which is how p and ds go from one product
// to the next without leaving registers.
// --------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// whether the tensor-core paths can read these rows: 16-byte aligned
// pointers and a head dim they are built for
__host__ __forceinline__ bool mma_rows_ok(const void* const* ptrs, int n,
                                          int D) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  return D == 64 || D == 128;
}

}  // namespace bps

extern "C" const char* bps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
