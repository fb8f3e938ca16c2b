// Block top-k for Hopper (sm_90a): selection, reconstruct-sum and the fused
// single-worker round trip.
//
// Replaces byteps_tpu/ops/topk_kernels.py:_select_kernel (via _select_pallas,
// block_select), :_reconstruct_kernel (via _reconstruct_pallas,
// block_reconstruct_sum) and :_roundtrip_kernel (via _roundtrip_pallas,
// block_roundtrip).
//
// Winner rule (the Pallas kernels', not argmax): in each group, the smallest
// index where |x| equals the group's max |x|. A group holding a NaN has a NaN
// max, which equals nothing, so it has no winner: index = group size, value
// 0, dense 0, residual x. A winner's value is x + 0.0f, as the reference's
// one-hot sum gives it (-0.0 becomes 0.0); the round trip keeps x itself in
// the dense slot, as the reference's round trip does.
//
// select: (block, rows) f32, lane c's group is {c, c + rows, ...}, slots at
// flat index >= n excluded (the ragged tail chunk: they never win).
// roundtrip: x (+ e) viewed (J, g, 128); group (j, lane) is {(j g + i) 128 +
// lane : i < g}. Both are a column first-max over a (G, W) matrix of row
// stride W. A 1,024,000-element chunk has only 10,240 groups of 100, so one
// thread per group would leave most of the card idle: a block of 32 lanes x
// kSplit threads gives each thread every kSplit-th row of its column (a warp
// reads 32 consecutive floats of a row: coalesced), and the kSplit partial
// winners of a lane combine as (|x|, index) pairs in shared memory: larger
// |x| wins, a tie goes to the smaller index, a NaN anywhere removes the
// winner. That equals strict first-max whatever the split. The round trip's
// second pass re-reads x and e (from L2, just read) and writes dense and
// residual = (x + e) - dense.
//
// reconstruct_sum: one thread per output element (r, c) takes payload 0's
// term (locals[0][c] == r ? vals[0][c] : 0) and adds payload k's in order
// k = 1..K-1 (K >= 1): the Pallas kernel's sum as XLA compiles it (its first
// add, to 0.0, folded away), so a lone -0.0 stays -0.0; the plain version's
// bit for bit.
//
// What bounds them: bytes. The round trip at (80, 100) with e reads 8 MB and
// writes 8 MB, about 4.9 us at 3.35 TB/s; select at (100, 10240) reads
// 4.1 MB and reconstruct (K = 1) writes 4.1 MB, about 1.2 us each.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;    // lanes (columns) a block covers
constexpr int kSplit = 16;    // threads sharing one column's rows
constexpr int kTileLanes = 128;
constexpr int kReconThreads = 256;

struct Best {
  float m;     // max |x| seen (-1: none)
  int idx;     // its first index
  bool nan;    // a NaN was seen
};

__device__ __forceinline__ void scan(Best& b, float a, int i) {
  if (a != a) {
    b.nan = true;
  } else if (a > b.m) {    // strictly greater: the first max stays
    b.m = a;
    b.idx = i;
  }
}

// Combine the kSplit partial winners of each lane of the block; returns the
// lane's winner (G when none) to every thread of the lane.
__device__ __forceinline__ int combine(Best b, int G) {
  __shared__ float sm_m[kSplit][kLanes];
  __shared__ int sm_i[kSplit][kLanes];
  __shared__ bool sm_nan[kSplit][kLanes];
  __shared__ int sm_w[kLanes];
  const int tx = threadIdx.x, ty = threadIdx.y;
  sm_m[ty][tx] = b.m;
  sm_i[ty][tx] = b.idx;
  sm_nan[ty][tx] = b.nan;
  __syncthreads();
  if (ty == 0) {
    Best w = b;
    for (int s = 1; s < kSplit; ++s) {
      const float m = sm_m[s][tx];
      const int i = sm_i[s][tx];
      w.nan |= sm_nan[s][tx];
      if (m > w.m || (m == w.m && i < w.idx)) {
        w.m = m;
        w.idx = i;
      }
    }
    sm_w[tx] = w.nan ? G : w.idx;
  }
  __syncthreads();
  return sm_w[tx];
}

__global__ void __launch_bounds__(kLanes * kSplit)
select_kernel(const float* __restrict__ x, int* __restrict__ local,
              float* __restrict__ vals, int block, int rows, long long n) {
  const int c = blockIdx.x * kLanes + threadIdx.x;
  Best b{-1.f, block, false};
  // rows of lane c inside the first n flat slots
  const int iend = c < rows ? (int)min((long long)block,
                                       (n - c + rows - 1) / rows)
                            : 0;
#pragma unroll 4
  for (int i = threadIdx.y; i < iend; i += kSplit)
    scan(b, fabsf(x[(long long)i * rows + c]), i);
  const int w = combine(b, block);
  if (threadIdx.y == 0 && c < rows) {
    local[c] = w;
    vals[c] = w < block ? __fadd_rn(x[(long long)w * rows + c], 0.f) : 0.f;
  }
}

__global__ void __launch_bounds__(kReconThreads)
reconstruct_sum_kernel(const int* __restrict__ locals,
                       const float* __restrict__ vals, float* __restrict__ out,
                       int K, int block, int rows) {
  const int c = blockIdx.x * kReconThreads + threadIdx.x;
  if (c >= rows) return;
  for (int r = blockIdx.y; r < block; r += gridDim.y) {
    float acc = locals[c] == r ? vals[c] : 0.f;
    for (int k = 1; k < K; ++k) {
      const long long kc = (long long)k * rows + c;
      acc = __fadd_rn(acc, locals[kc] == r ? vals[kc] : 0.f);
    }
    out[(long long)r * rows + c] = acc;
  }
}

template <bool kWithE>
__global__ void __launch_bounds__(kLanes * kSplit)
roundtrip_kernel(const float* __restrict__ x, const float* __restrict__ e,
                 float* __restrict__ dense, float* __restrict__ resid, int g) {
  constexpr int kQuarters = kTileLanes / kLanes;
  const long long j = blockIdx.x / kQuarters;
  const int lane = (blockIdx.x % kQuarters) * kLanes + threadIdx.x;
  const long long base = j * g * kTileLanes + lane;
  Best b{-1.f, g, false};
#pragma unroll 4
  for (int i = threadIdx.y; i < g; i += kSplit) {
    const long long f = base + (long long)i * kTileLanes;
    const float v = kWithE ? __fadd_rn(x[f], e[f]) : x[f];
    scan(b, fabsf(v), i);
  }
  const int w = combine(b, g);
#pragma unroll 4
  for (int i = threadIdx.y; i < g; i += kSplit) {
    const long long f = base + (long long)i * kTileLanes;
    const float v = kWithE ? __fadd_rn(x[f], e[f]) : x[f];
    const float d = i == w ? v : 0.f;
    dense[f] = d;
    resid[f] = __fsub_rn(v, d);
  }
}

}  // namespace

// x: (block, rows) f32; local: rows int32; vals: rows f32; slots at flat
// index >= n never win (rows <= n <= block * rows). Returns a cudaError_t.
extern "C" int bps_topk_select(const void* x, void* local, void* vals,
                               int block, int rows, long long n,
                               void* stream) {
  if (rows == 0) return 0;
  select_kernel<<<(rows + kLanes - 1) / kLanes, dim3(kLanes, kSplit), 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int*>(local),
      static_cast<float*>(vals), block, rows, n);
  return (int)cudaGetLastError();
}

// locals, vals: (K, rows) int32 / f32; out: (block, rows) f32.
extern "C" int bps_topk_reconstruct_sum(const void* locals, const void* vals,
                                        void* out, int K, int block, int rows,
                                        void* stream) {
  if (rows == 0 || block == 0) return 0;
  const dim3 grid((rows + kReconThreads - 1) / kReconThreads,
                  block < 1024 ? block : 1024);
  reconstruct_sum_kernel<<<grid, kReconThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(locals), static_cast<const float*>(vals),
      static_cast<float*>(out), K, block, rows);
  return (int)cudaGetLastError();
}

// x, e (may be null), dense, resid: J * g * 128 f32.
extern "C" int bps_topk_roundtrip(const void* x, const void* e, void* dense,
                                  void* resid, int J, int g, void* stream) {
  if (J == 0 || g == 0) return 0;
  const unsigned blocks = (unsigned)J * (kTileLanes / kLanes);
  const dim3 threads(kLanes, kSplit);
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto ep = static_cast<const float*>(e);
  auto dp = static_cast<float*>(dense);
  auto rp = static_cast<float*>(resid);
  if (e != nullptr)
    roundtrip_kernel<true><<<blocks, threads, 0, s>>>(xp, ep, dp, rp, g);
  else
    roundtrip_kernel<false><<<blocks, threads, 0, s>>>(xp, ep, dp, rp, g);
  return (int)cudaGetLastError();
}

extern "C" const char* bps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
