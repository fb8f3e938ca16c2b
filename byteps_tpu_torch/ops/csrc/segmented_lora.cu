// Segmented LoRA delta for Hopper (sm_90a): every packed row's own
// low-rank delta, out[r] = (x[r] @ A[slots[r]]) @ B[slots[r]].
//
// Replaces byteps_tpu/ops/segmented_lora.py:_delta_pallas (the kernel body
// at :87, pallas_call :107; via segmented_lora_delta :114). Its arithmetic
// is the Pallas body's: x upcast to f32, A and B f32, u = x @ A kept in f32,
// out = (u @ B) cast to x's dtype, by f32 FMAs (tensor cores would round A
// and B). Slot 0 of a pool is all zeros, so a finite row on slot 0 gets
// exactly +0.0.
//
// Layout: x (R, S, d_in) bf16 or f32, contiguous; A (n_slots, d_in, rb) and
// B (n_slots, rb, d_out) f32 whose inner two dims are contiguous and whose
// slot stride is passed in (a layer's slice of the pool's (n_slots, L, d_in,
// rb) slab is a strided view; nothing is copied); slots (R,) int32; out
// (R, S, d_out) in x's dtype.
//
// Grid: (cluster, S, R), in clusters of `cluster` blocks along x: one
// cluster takes one (row r, position s), so the positions of a row run in
// parallel, each on clusters of its own with no barrier between them, and
// block c of a cluster writes the output columns [c * cols, (c + 1) *
// cols). The plan (`plan` below, a function of d_in, the rank bucket and
// d_out alone) gives cluster, cols and `part`, the d_in rows of one
// warp's share: one block alone (no cluster) while a row's A is small
// (the packed decode step's 1024 x 8), up to 8 as A grows (w2's 4096 x 8:
// 4; rank 64: 8). A block reads its row's slot itself (Hopper has no
// scalar prefetch) and never reads the slab for a slot outside [0,
// n_slots): the wrapper refuses those, and the kernel writes NaN.
//   start: the block starts cp.async copies of its columns of B (all rb
//     rows, up to kStageFloats floats) into shared memory; they land
//     while u is summed.
//   phase 1, u once per (row, position): warp w of block c sums d_in rows
//     [(c * 8 + w) * part, + part). A lane owns 4 adjacent ranks j (RB / 4
//     groups) and every (128 / RB)-th d_in row k of the share, so each
//     step of the warp reads 128 consecutive floats of A as one 16-byte
//     vector a lane, and chains acc[j] = fmaf(x[k], A[k, j], acc[j]) over
//     its k in order from +0.0. A fixed xor-shuffle tree adds the lanes of
//     one j group; the block adds its 8 warp partials in warp order and
//     stores the sum into slot c of every block of the cluster through
//     distributed shared memory; after one cluster barrier every block
//     adds the slots in cluster-rank order, so every block holds the
//     whole u, and no block reads another's memory, so none waits to
//     leave.
//   phase 2: a thread takes 4 adjacent output columns: it chains
//     fmaf(u[j], B[j, n], acc) over j = 0 .. rb-1 in order from +0.0, with
//     B read as 16-byte vectors from shared memory, and stores the 4
//     results at once (8 bytes in bf16).
// The row-parallel arm (a tensor-parallel wo or w2, whose d_in is split
// over tp ranks) needs a seam between the two products, where u is summed
// over the ranks: the same kernel runs as two launches there. The *down*
// launch (mode 1) runs phase 1 on the plan of (d_in, rank bucket, d_out)
// and block 0 of each cluster stores u as f32 (R, S, rb); the *up* launch
// (mode 2) reads that (summed) u instead of phase 1 and runs phase 2, with
// no cluster (its blocks share nothing). Each u is summed in the fused
// launch's order and each output chains over u in the same order, so at
// one rank down + up equals the fused launch bit for bit.
// No atomics, no second kernel; one block-wide barrier per stage. f32
// FMAs throughout: the work is tiny (4.2 MFLOP at rank 64, R = 16), and
// mma.sync or wgmma would round A and B to bf16 or TF32.
// Batch invariance: each u and each output element is summed in an order
// fixed by (d_in, rank bucket, d_out) through the plan, never by R, S,
// the row's index, its slot or the rows beside it (a row's chains and
// trees are the same whichever rows run in the launch). So a row computed
// in a packed decode batch, in a prefill chunk or in a solo step comes
// out bit for bit the same, which is what keeps pooled tokens equal to
// solo ones. Vector or scalar loads change no sum.
//
// What bounds it: latency, then bytes. At the packed decode shape (R = 16,
// S = 1, 1024 -> 8 -> 1024, bf16) it reads 32 KB of x and up to 16 x 64 KB
// of slabs and writes 32 KB, about 1.1 MB or 0.33 us at 3.35 TB/s, for 0.5
// MFLOP (rank 64: 4.2 MFLOP, 0.06 us at 67 TFLOP/s f32). A launch is a
// chain of dependent steps: the slot, then A and x, the trees, the
// cluster barrier (where there is a cluster), then B from shared memory.
// Each row reads its A once (the cluster's blocks split d_in), where a
// block of every 256-column d_out tile used to read all of it; a cluster
// costs its barrier, so a small A stays on one block, whose one SM then
// pulls the row's whole B.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "cluster.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kBlockCols = 128;      // output columns a cluster's block
constexpr int kSoloFloats = 8192;    // the most of A one block sums alone
constexpr int kStageFloats = 16384;  // B staged in shared memory (64 KB)
constexpr int kBatch = 8;            // A vectors a lane keeps in flight

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

// acc += u * b, a column at a time
__device__ __forceinline__ void fma4(float4& acc, float u, float4 b) {
  acc.x = fmaf(u, b.x, acc.x);
  acc.y = fmaf(u, b.y, acc.y);
  acc.z = fmaf(u, b.z, acc.z);
  acc.w = fmaf(u, b.w, acc.w);
}

__device__ __forceinline__ void store4(float* p, float4 v, int valid,
                                       bool vec) {
  if (vec && valid == 4) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
  for (int c = 0; c < valid; ++c) p[c] = e[c];
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v, int valid,
                                       bool vec) {
  if (vec && valid == 4) {
    uint2 w;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    w.x = *reinterpret_cast<const uint32_t*>(&lo);
    w.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = w;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
  for (int c = 0; c < valid; ++c) p[c] = __float2bfloat16_rn(e[c]);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

using bps::cluster_arrive;
using bps::cluster_arrive_relaxed;
using bps::cluster_wait;
using bps::st_cluster;

template <typename T, int RB>
__global__ void __launch_bounds__(kThreads)
segmented_lora_kernel(const T* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ b,
                      const int* __restrict__ slots, T* __restrict__ out,
                      float* __restrict__ u_io, int S, int d_in, int rb,
                      int d_out, int n_slots, long long a_stride,
                      long long b_stride, int part, int cols, int staged,
                      int mode) {
  constexpr int kGroups = RB / 4;       // 4-rank groups a d_in row
  constexpr int kLanesK = 32 / kGroups; // d_in rows a warp step covers
  __shared__ float warp_u[kWarps][RB];
  __shared__ float parts[kMaxCluster][RB];  // parts[q] written by block q
  __shared__ float u[RB];
  extern __shared__ float4 stage4[];     // B's staged columns: [rb][staged]
  float* stage = reinterpret_cast<float*>(stage4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x;             // cluster rank (cluster along x)
  const int s = blockIdx.y;
  const int r = blockIdx.z;
  const int col0 = c * cols;
  const int ncol = max(0, min(cols, d_out - col0));
  const int nstage = min(ncol, staged);
  T* o = out + ((long long)r * S + s) * d_out + col0;
  const bool vec_out = (d_out & 3) == 0;
  float* ur = u_io + ((long long)r * S + s) * rb;   // modes 1 and 2
  const int slot = slots[r];
  if (slot < 0 || slot >= n_slots) {    // the whole cluster leaves here
    if (mode == 1) {
      if (c == 0 && tid < rb) ur[tid] = nanf("");
    } else {
      for (int i = tid; i < ncol; i += kThreads) o[i] = from_f32<T>(nanf(""));
    }
    return;
  }
  const float* A = a + slot * a_stride;
  const float* B = b + slot * b_stride;
  // no block stores into another's shared memory before every block of
  // the cluster has started: this phase of the barrier says so
  // (1: no cluster, nothing to share; the up launch has none)
  const int nc = mode == 2 ? 1 : gridDim.x;
  if (nc > 1) cluster_arrive_relaxed();

  // B's staged columns start landing now (not in the down launch)
  if (mode != 1) {
    const float* src = B + col0;
    const bool v16 = vec_out && (((uintptr_t)src & 15) == 0) &&
                     (nstage & 3) == 0;
    if (v16) {
      const int per_row = nstage >> 2;
      for (int i = tid; i < rb * per_row; i += kThreads) {
        const int j = i / per_row, q = (i - j * per_row) << 2;
        cp_async16(stage + j * staged + q, src + (long long)j * d_out + q);
      }
    } else {
      for (int i = tid; i < rb * nstage; i += kThreads) {
        const int j = i / nstage, q = i - j * nstage;
        cp_async4(stage + j * staged + q, src + (long long)j * d_out + q);
      }
    }
  }

  // phase 1: this warp's share of d_in (the up launch reads u instead)
  if (mode == 2) {
    if (tid < rb) u[tid] = ur[tid];
  } else {
    const int jg = lane % kGroups, kl = lane / kGroups;
    const int j0 = 4 * jg;
    const int kbeg = (c * kWarps + warp) * part;
    const int kend = min(d_in, kbeg + part);
    const T* xs = x + ((long long)r * S + s) * d_in;
    const bool vec_a = rb == RB && (((uintptr_t)A & 15) == 0);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = kbeg; k0 < kend; k0 += kBatch * kLanesK) {
      float4 av[kBatch];
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        const int k = k0 + t * kLanesK + kl;
        av[t] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k < kend) {
          const float* p = A + (long long)k * rb + j0;
          if (vec_a) {
            av[t] = __ldg(reinterpret_cast<const float4*>(p));
          } else {
            if (j0 < rb) av[t].x = __ldg(p);
            if (j0 + 1 < rb) av[t].y = __ldg(p + 1);
            if (j0 + 2 < rb) av[t].z = __ldg(p + 2);
            if (j0 + 3 < rb) av[t].w = __ldg(p + 3);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        const int k = k0 + t * kLanesK + kl;
        if (k < kend) {
          const float xv = to_f32(xs[k]);
          acc[0] = fmaf(xv, av[t].x, acc[0]);
          acc[1] = fmaf(xv, av[t].y, acc[1]);
          acc[2] = fmaf(xv, av[t].z, acc[2]);
          acc[3] = fmaf(xv, av[t].w, acc[3]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = acc[q];
#pragma unroll
      for (int off = kGroups; off < 32; off <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (kl == 0) warp_u[warp][j0 + q] = v;
    }
  }
  __syncthreads();
  // the block's partial, pushed into slot c of every block of the cluster
  if (nc > 1) cluster_wait();
  if (mode != 2 && tid < rb) {
    float v = warp_u[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += warp_u[w][tid];
    if (nc == 1)
      u[tid] = v;
    else
      for (int q = 0; q < nc; ++q) st_cluster(&parts[c][tid], q, v);
  }
  if (nc > 1) {
    cluster_arrive();
    cluster_wait();                     // every block's partial is here
    if (tid < rb) {
      float v = parts[0][tid];
      for (int q = 1; q < nc; ++q) v += parts[q][tid];
      u[tid] = v;
    }
  }
  if (mode == 1) {                      // down: u out, every block has it
    if (c == 0 && tid < rb) ur[tid] = u[tid];
    return;
  }
  cp_async_wait_all();
  __syncthreads();

  // phase 2: 4 adjacent columns a thread
  for (int n = tid << 2; n < ncol; n += kThreads << 2) {
    const int valid = min(4, ncol - n);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < nstage) {                   // nstage: a multiple of 4, or ncol
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        if (j < rb) {
          // staged is a multiple of 4: a whole vector, whose columns
          // past ncol are never stored
          fma4(acc, u[j],
               *reinterpret_cast<const float4*>(stage + j * staged + n));
        }
      }
    } else {                            // past the staged columns
      const float* src = B + col0 + n;
      const bool v16 = vec_out && valid == 4 && (((uintptr_t)src & 15) == 0);
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        if (j < rb) {
          const float* p = src + (long long)j * d_out;
          float4 bv;
          if (v16) {
            bv = __ldg(reinterpret_cast<const float4*>(p));
          } else {
            bv.x = __ldg(p);
            bv.y = valid > 1 ? __ldg(p + 1) : 0.f;
            bv.z = valid > 2 ? __ldg(p + 2) : 0.f;
            bv.w = valid > 3 ? __ldg(p + 3) : 0.f;
          }
          fma4(acc, u[j], bv);
        }
      }
    }
    store4(o + n, acc, valid, vec_out);
  }
}

// The launch plan, a function of (d_in, rank bucket, d_out) alone, so
// that every sum's order is too: the blocks of the cluster that takes one
// (row, position), one while a row's A (d_in x bucket floats) fits
// kSoloFloats and more as it grows, each about kBlockCols columns wide;
// `cols`, a block's output columns (a multiple of 4, every block some);
// `part`, the d_in rows each of the cluster's warps sums, in whole steps
// of 128 / bucket rows; `staged`, the columns of B a block stages (a
// multiple of 4; it changes where B is read from, not a sum).
struct Plan {
  int cluster, cols, part, staged;
};

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

template <int RB>
Plan plan(int d_in, int rb, int d_out) {
  Plan p;
  p.cluster = std::max(1, std::min({kMaxCluster, ceil_div(d_out, kBlockCols),
                                    ceil_div((long long)d_in * RB,
                                             kSoloFloats)}));
  p.cols = std::max(4, ceil_div(ceil_div(d_out, p.cluster), 4) * 4);
  constexpr int step = 128 / RB;
  p.part = ceil_div(std::max(1, ceil_div(d_in, kWarps * p.cluster)), step) *
           step;
  p.staged = std::min(p.cols, (kStageFloats / rb) & ~3);
  return p;
}

// Lift the dynamic shared memory limit to the stage's size, once per
// instantiation and device.
template <typename T, int RB>
int set_attributes() {
  static std::atomic<unsigned> done{0};   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = 1u << (dev & 31);
  if (done.load() & bit) return 0;
  err = cudaFuncSetAttribute(segmented_lora_kernel<T, RB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kStageFloats * (int)sizeof(float));
  if (err != cudaSuccess) return (int)err;
  done.fetch_or(bit);
  return 0;
}

template <typename T, int RB>
int launch(const void* x, const void* a, const void* b, const void* slots,
           void* out, void* u_io, int R, int S, int d_in, int rb, int d_out,
           int n_slots, long long a_stride, long long b_stride, int mode,
           cudaStream_t stream) {
  const int err = set_attributes<T, RB>();
  if (err != 0) return err;
  const Plan p = plan<RB>(d_in, rb, d_out);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, S, R);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = mode == 1 ? 0 : (size_t)rb * p.staged * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  // one block a row, or the up launch: no cluster
  cfg.numAttrs = p.cluster > 1 && mode != 2 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, segmented_lora_kernel<T, RB>, static_cast<const T*>(x),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const int*>(slots), static_cast<T*>(out),
      static_cast<float*>(u_io), S, d_in, rb, d_out, n_slots, a_stride,
      b_stride, p.part, p.cols, p.staged, mode);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* a, const void* b, const void* slots,
             void* out, void* u_io, int R, int S, int d_in, int rb, int d_out,
             int n_slots, long long a_stride, long long b_stride, int mode,
             cudaStream_t stream) {
  if (rb <= 8)
    return launch<T, 8>(x, a, b, slots, out, u_io, R, S, d_in, rb, d_out,
                        n_slots, a_stride, b_stride, mode, stream);
  if (rb <= 16)
    return launch<T, 16>(x, a, b, slots, out, u_io, R, S, d_in, rb, d_out,
                         n_slots, a_stride, b_stride, mode, stream);
  if (rb <= 32)
    return launch<T, 32>(x, a, b, slots, out, u_io, R, S, d_in, rb, d_out,
                         n_slots, a_stride, b_stride, mode, stream);
  return launch<T, 64>(x, a, b, slots, out, u_io, R, S, d_in, rb, d_out,
                       n_slots, a_stride, b_stride, mode, stream);
}

}  // namespace

// x (R, S, d_in) bf16 (is_bf16 = 1) or f32; a, b: the slabs' slot-0
// pointers, a_stride / b_stride their slot strides in floats; slots (R,)
// int32; out (R, S, d_out) in x's dtype; u (R, S, rb) f32; 1 <= rb <= 64.
// mode 0: the fused launch (u unused); 1: the down half, x and A -> u (out
// and B unused, d_out still sets the plan); 2: the up half, u and B -> out
// (x and A unused, d_in still sets the plan). All on the card. Returns a
// cudaError_t (0 = success; cudaErrorInvalidValue for rb > 64 or a mode
// outside 0..2).
extern "C" int bps_segmented_lora(const void* x, const void* a, const void* b,
                                  const void* slots, void* out, void* u,
                                  int R, int S, int d_in, int rb, int d_out,
                                  int n_slots, long long a_stride,
                                  long long b_stride, int is_bf16, int mode,
                                  void* stream) {
  if (rb < 1 || rb > 64 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  if (R == 0 || S == 0 || d_out == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(x, a, b, slots, out, u, R, S, d_in, rb,
                                   d_out, n_slots, a_stride, b_stride, mode,
                                   st);
  return dispatch<float>(x, a, b, slots, out, u, R, S, d_in, rb, d_out,
                         n_slots, a_stride, b_stride, mode, st);
}

extern "C" const char* bps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
