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
// lane : i < g}. Both are a column first-max over a matrix of row stride
// `rows` or 128. A block takes a slice of columns (select: 32 lanes; the
// round trip: 4 lw lanes of a tile, lw in {4, 8, 16, 32}) and rows of it,
// and a group taller than one block's threads can cover splits over the
// blocks of a thread-block cluster (up to 16), on a plan that is a
// function of the shapes alone (ops/topk_kernels.py select_plan,
// roundtrip_plan): the grid follows the chunk, not the number of groups,
// and columns split before rows, since a cluster costs its barriers. A
// thread scans its rows in increasing order with a strict > and no branch
// (its first max), so all its loads issue before the first scan; the
// partials then fold by `merge` (larger |v| wins, a tie goes to the
// smaller index, a NaN anywhere removes the winner): a max under a total
// order, so it equals strict first-max in any fold order. They fold by
// warp shuffles between the threads of a warp that share a column, a
// shared table between warps, and a 16-byte push of each block's partial
// into every cluster block's shared memory (DSMEM) before one cluster
// barrier. Select carries the winner's value through the fold, so nothing
// reads it back.
//
// The round trip reads x and e once: a thread holds v = x + e of its rows
// (up to kRows of 4 lanes, 16-byte loads) in registers from the scan to
// the writes of dense (v at the winner, else 0) and residual v - dense
// (streaming stores). A group taller than a cluster's registers (g > 16 x
// 512 / lw x kRows, past 8,192 rows) scans its extra rows and reads them
// again to write them. A view of x or e at a 4-byte offset takes the
// scalar variant (kVec false): the same plan and arithmetic, 4-byte loads
// and stores, a thread's lanes lw apart so that a warp's accesses are
// consecutive floats.
//
// reconstruct_sum: element (r, c) is payload 0's term (locals[0][c] == r ?
// vals[0][c] : 0) plus payload k's in order k = 1..K-1 (K >= 1): the
// Pallas kernel's sum as XLA compiles it (its first add, to 0.0, folded
// away), so a lone -0.0 stays -0.0; the plain version's bit for bit. A
// local that is negative or >= block (select's "no winner") matches no
// row. A warp holds a 128-column slice and a stripe of up to 8 rows; a
// thread 4 columns (adjacent, with 16-byte loads and stores, where rows
// % 4 == 0 and the pointers are 16-byte aligned; else 32 apart, 4-byte
// accesses, so a warp's store is 128 consecutive bytes) and the stripe's
// sums in registers. It reads its columns' K pairs once, 8 payloads in
// flight, before its first store, then writes its rows with streaming
// stores. So no K needs passes over L2: the registers hold the stripe,
// not the pairs. The grid (slices / warps a block, stripes) follows the
// output, on a plan that is a function of the shapes alone
// (ops/topk_kernels.py reconstruct_plan). It used to run one thread per
// element on a grid of (rows / 256, min(block, 1024)) blocks, each row
// reading its column's K pairs again. On an H100, stripes of up to 16
// rows (4 payloads in flight) and storing the stripe's zeros while the
// pairs load, then each hit, were no faster at the tail and slower at
// K = 8.
//
// What bounds them: bytes. The round trip at (80, 100) with e reads 8 MB and
// writes 8 MB, about 4.9 us at 3.35 TB/s; select at (100, 10240) reads
// 4.1 MB and reconstruct (K = 1) writes 4.1 MB, about 1.2 us each. At these
// sizes a launch and one memory round trip are as large as the bound, so
// every load a thread makes is in flight at once, every block of a chunk
// is resident at once (the round trip at most 64 registers a thread), and
// the partials fold with no serial pass between the reads and the writes.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "cluster.cuh"

namespace {

using bps::cluster_arrive;
using bps::cluster_arrive_relaxed;
using bps::cluster_id;
using bps::cluster_rank;
using bps::cluster_wait;
using bps::map_cluster;
using bps::st_cluster;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 512;  // a block of select or the round trip
constexpr int kMaxCluster = 16;   // blocks a cluster (above 8: non-portable)
constexpr int kRows = 4;          // rows a round-trip thread keeps
constexpr int kSelRows = 8;       // loads a select thread keeps in flight
constexpr int kTileLanes = 128;
// reconstruct_sum: rows a thread holds at most, payloads whose pairs it
// loads at once, threads a block at most
constexpr int kReconRows = 8;
constexpr int kReconBatch = 8;
constexpr int kReconMaxThreads = 256;
// combine's tables: (warps + cluster + 1) x 128 groups x 16 bytes
constexpr int kMaxSmem = (kMaxThreads / 32 + kMaxCluster + 1) * kTileLanes * 16;

// A partial winner: its |v| and index, and v itself where the caller needs
// it (kVal: select). A NaN seen is (+inf, INT_MIN): it beats every other
// pair, a real inf included, and stays, so a group that holds one ends
// with no winner.
template <bool kVal> struct Best;
template <> struct Best<false> {
  float m;  // max |v| seen (-1: none)
  int idx;  // its first index
};
template <> struct Best<true> {
  float m;
  int idx;
  float val;  // v there
};

constexpr int kNanIdx = -2147483647 - 1;

#ifdef BPS_TOPK_STAMPS
// Phase stamps (scripts/torch_topk_stamps.py builds this variant): thread 0
// of each of the first kStampBlocks blocks writes %globaltimer at entry,
// after its scan, after the fold and after its last store is issued.
constexpr int kStampBlocks = 1 << 12;
__device__ unsigned long long stamps[kStampBlocks][4];
// (after `dep` is computed and every memory access before it is issued)
__device__ __forceinline__ void stamp(int k, float dep = 0.f) {
  if (threadIdx.x == 0 && blockIdx.x < kStampBlocks) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t) : "f"(dep)
                 : "memory");
    stamps[blockIdx.x][k] = t;
  }
}
#else
__device__ __forceinline__ void stamp(int, float = 0.f) {}
#endif

template <bool kVal>
__device__ __forceinline__ Best<kVal> none(int G) {
  Best<kVal> b;
  b.m = -1.f;
  b.idx = G;
  if constexpr (kVal) b.val = 0.f;
  return b;
}

template <bool kVal>
__device__ __forceinline__ float4 pack(const Best<kVal>& b) {
  float val = 0.f;
  if constexpr (kVal) val = b.val;
  return make_float4(b.m, __int_as_float(b.idx), val, 0.f);
}
template <bool kVal>
__device__ __forceinline__ Best<kVal> unpack(float4 f) {
  Best<kVal> b;
  b.m = f.x;
  b.idx = __float_as_int(f.y);
  if constexpr (kVal) b.val = f.z;
  return b;
}

// the group's winner index, G when it held a NaN
template <bool kVal>
__device__ __forceinline__ int winner(const Best<kVal>& b, int G) {
  return b.idx == kNanIdx ? G : b.idx;
}

// rows in increasing i: strictly greater, so the first max stays. Branch
// free, so that a thread's loads all issue ahead of its scans: a slot
// that is not the thread's (`ok` false) scans as |v| = -1, which never
// wins.
template <bool kVal>
__device__ __forceinline__ void scan(Best<kVal>& b, float v, int i,
                                     bool ok = true) {
  const float a = ok ? fabsf(v) : -1.f;
  const bool nan = a != a, gt = a > b.m;
  b.idx = nan ? kNanIdx : gt ? i : b.idx;
  if constexpr (kVal) b.val = gt ? v : b.val;
  b.m = nan ? __int_as_float(0x7f800000) : gt ? a : b.m;
}

// o into b: the larger |v|, on a tie the smaller index (a NaN's pair wins)
template <bool kVal>
__device__ __forceinline__ void merge(Best<kVal>& b, const Best<kVal>& o) {
  const bool take = o.m > b.m || (o.m == b.m && o.idx < b.idx);
  b.m = take ? o.m : b.m;
  b.idx = take ? o.idx : b.idx;
  if constexpr (kVal) b.val = take ? o.val : b.val;
}

template <bool kVal>
__device__ __forceinline__ Best<kVal> shfl_xor(const Best<kVal>& b,
                                               int off) {
  Best<kVal> o;
  o.m = __shfl_xor_sync(kFull, b.m, off);
  o.idx = __shfl_xor_sync(kFull, b.idx, off);
  if constexpr (kVal) o.val = __shfl_xor_sync(kFull, b.val, off);
  return o;
}

// the n partials p[0], p[stride], ... folded; their loads go out 4 at a
// time ahead of the merges (a slot past n merges p[0] again: no change)
template <bool kVal>
__device__ __forceinline__ Best<kVal> fold(const float4* p, int n,
                                           int stride) {
  Best<kVal> r = unpack<kVal>(p[0]);
  for (int k0 = 1; k0 < n; k0 += 4) {
    float4 f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = p[k0 + k < n ? (k0 + k) * stride : 0];
#pragma unroll
    for (int k = 0; k < 4; ++k) merge(r, unpack<kVal>(f[k]));
  }
  return r;
}

// Fold the partial winners of the block's threads, then of its cluster's C
// blocks, for the block's ct * NL groups: thread tid = s * ct + q (ct
// divides 32) holds groups q * NL .. q * NL + NL - 1 over its rows. Every
// thread calls it; with C > 1 the block is rank `rank` of a cluster that
// arrived (relaxed) at kernel start. Returns the groups' winners, in
// shared memory, to every thread.
template <int NL, bool kVal>
__device__ __forceinline__ const float4* combine(Best<kVal> (&b)[NL], int ct,
                                                 int C, int rank, float4* sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = blockDim.x >> 5, LB = ct * NL;
  float4* part = sm;            // [W][LB]: each warp's partials
  float4* slot = sm + W * LB;   // [C][LB]: each cluster block's
  float4* win = slot + C * LB;  // [LB]
  for (int off = ct; off < 32; off <<= 1) {
#pragma unroll
    for (int l = 0; l < NL; ++l) merge(b[l], shfl_xor(b[l], off));
  }
  if (lane < ct) {
#pragma unroll
    for (int l = 0; l < NL; ++l) part[warp * LB + lane * NL + l] = pack(b[l]);
  }
  __syncthreads();
  if (C > 1) cluster_wait();  // every block of the cluster has started
  for (int t = tid; t < LB; t += blockDim.x) {
    const float4 f = pack(fold<kVal>(part + t, W, LB));
    if (C == 1) {
      win[t] = f;
    } else {
      for (int k = 0; k < C; ++k)
        st_cluster(map_cluster(slot + rank * LB + t, k), f);
    }
  }
  if (C > 1) {
    cluster_arrive();
    cluster_wait();  // every block's partials are here
    for (int t = tid; t < LB; t += blockDim.x)
      win[t] = pack(fold<kVal>(slot + t, C, LB));
  }
  __syncthreads();
  return win;
}

// Block `rank` of cluster cl holds rows [rank L, min(end, rank L + L)) of
// lanes [32 cl, 32 cl + 32); its thread (s, q) (tid = 32 s + q) the rows
// rank L + s + k S of lane 32 cl + q, S = blockDim.x / 32.
__global__ void __launch_bounds__(kMaxThreads)
select_kernel(const float* __restrict__ x, int* __restrict__ local,
              float* __restrict__ vals, int block, int rows, int nq, int nr,
              int C, int L) {
  extern __shared__ float4 sm[];
  const int S = blockDim.x >> 5, s = threadIdx.x >> 5, q = threadIdx.x & 31;
  const int rank = C > 1 ? cluster_rank() : 0;
  const int c = (C > 1 ? cluster_id() : (int)blockIdx.x) * 32 + q;
  if (C > 1) cluster_arrive_relaxed();
  // rows of lane c inside the first n = nq rows + nr flat slots
  const int r1 = min(c < rows ? nq + (c < nr) : 0, rank * L + L);
  stamp(0);
  Best<true> b[1] = {none<true>(block)};
  for (int i0 = rank * L + s; i0 < r1; i0 += kSelRows * S) {
    // every load in flight before the first use: unconditional, a row
    // past the lane's end reading its last row again (not scanned)
    float t[kSelRows];
#pragma unroll
    for (int k = 0; k < kSelRows; ++k)
      t[k] = __ldg(x + min(i0 + k * S, r1 - 1) * rows + c);
#pragma unroll
    for (int k = 0; k < kSelRows; ++k)
      scan(b[0], t[k], i0 + k * S, i0 + k * S < r1);
  }
  stamp(1, b[0].m);
  const float4* win = combine(b, 32, C, rank, sm);
  stamp(2);
  if (rank == 0 && s == 0 && c < rows) {
    const Best<true> w = unpack<true>(win[q]);
    local[c] = winner(w, block);
    vals[c] = w.idx == kNanIdx ? 0.f : __fadd_rn(w.val, 0.f);
  }
  stamp(3);
}

// reconstruct_sum: the 4 columns of payload row p (a (K, rows) array) a
// thread holds: c0 .. c0 + 3 (kVec: one 16-byte load), else c0 + 32 i
// (4-byte loads; a warp reads consecutive words), columns at or past
// `rows` reading `pad`
template <bool kVec, typename T, typename T4>
__device__ __forceinline__ void load_cols(const T* p, int c0, int rows, T pad,
                                          T (&v)[4]) {
  if constexpr (kVec) {
    const T4 x = __ldg(reinterpret_cast<const T4*>(p + c0));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = c0 + 32 * i < rows ? __ldg(p + c0 + 32 * i) : pad;
  }
}

// Warp w of block (bx, by) holds column slice s = bx W + w (128 columns)
// and the stripes of R rows (R <= kReconRows) [r0, r0 + R), r0 = (by + m
// gridDim.y) R (one stripe but where the stripes outnumber the grid's
// 65,535 rows); its lane the 4 columns of load_cols from c0. A stripe's
// sums stay in registers while the K pairs of its columns stream in,
// kReconBatch payloads in flight, each read once.
template <bool kVec>
__global__ void __launch_bounds__(kReconMaxThreads)
reconstruct_sum_kernel(const int* __restrict__ locals,
                       const float* __restrict__ vals, float* __restrict__ out,
                       int K, int block, int rows, int R) {
  const int lane = threadIdx.x & 31;
  const int slice = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int c0 = slice * kTileLanes + (kVec ? 4 * lane : lane);
  if (c0 >= rows) return;   // every column of the thread is past rows
  for (long long r0 = (long long)blockIdx.y * R; r0 < block;
       r0 += (long long)gridDim.y * R) {
    float acc[kReconRows][4] = {};   // each set by payload 0's term
    // rows compare as unsigned: a negative local matches no row
    const unsigned rb = (unsigned)r0;
    for (int k0 = 0; k0 < K; k0 += kReconBatch) {
      int lo[kReconBatch][4];
      float va[kReconBatch][4];
#pragma unroll
      for (int t = 0; t < kReconBatch; ++t) {
        if (k0 + t < K) {
          const long long p = (long long)(k0 + t) * rows;
          load_cols<kVec, int, int4>(locals + p, c0, rows, -1, lo[t]);
          load_cols<kVec, float, float4>(vals + p, c0, rows, 0.f, va[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < kReconBatch; ++t) {
        if (k0 + t < K) {
          const bool first = k0 + t == 0;
#pragma unroll
          for (int i = 0; i < kReconRows; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float term =
                  (unsigned)lo[t][q] == rb + i ? va[t][q] : 0.f;
              acc[i][q] = first ? term : __fadd_rn(acc[i][q], term);
            }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kReconRows; ++i) {
      if (i < R && r0 + i < block) {
        float* o = out + (r0 + i) * rows + c0;
        if (kVec) {
          __stcs(reinterpret_cast<float4*>(o),
                 make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c0 + 32 * q < rows) __stcs(o + 32 * q, acc[i][q]);
        }
      }
    }
  }
}

// a thread's 4 lanes: f, f + 1, f + 2, f + 3 (kVec: one 16-byte access),
// else f, f + ls, f + 2 ls, f + 3 ls (4-byte accesses; the lanes of a warp
// then read and write consecutive floats)
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p, int ls) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + ls), __ldg(p + 2 * ls),
                     __ldg(p + 3 * ls));
}

template <bool kVec>
__device__ __forceinline__ void store4(float* p, float4 v, int ls) {
  if (kVec) {
    __stcs(reinterpret_cast<float4*>(p), v);
  } else {
    __stcs(p, v.x);
    __stcs(p + ls, v.y);
    __stcs(p + 2 * ls, v.z);
    __stcs(p + 3 * ls, v.w);
  }
}

// v = x (+ e) at a thread's 4 lanes from flat index f
template <bool kWithE, bool kVec>
__device__ __forceinline__ float4 load_v(const float* x, const float* e,
                                         int f, int ls) {
  float4 v = load4<kVec>(x + f, ls);
  if (kWithE) {
    const float4 a = load4<kVec>(e + f, ls);
    v = make_float4(__fadd_rn(v.x, a.x), __fadd_rn(v.y, a.y),
                    __fadd_rn(v.z, a.z), __fadd_rn(v.w, a.w));
  }
  return v;
}

__device__ __forceinline__ void scan4(Best<false> (&b)[4], float4 v, int i,
                                      bool ok = true) {
  scan(b[0], v.x, i, ok);
  scan(b[1], v.y, i, ok);
  scan(b[2], v.z, i, ok);
  scan(b[3], v.w, i, ok);
}

// dense = v at the lanes whose winner is row i, else 0; residual v - dense
template <bool kVec>
__device__ __forceinline__ void write4(float* dense, float* resid, int f,
                                       int ls, float4 v, int i,
                                       const int (&w)[4]) {
  const float4 d = make_float4(i == w[0] ? v.x : 0.f, i == w[1] ? v.y : 0.f,
                               i == w[2] ? v.z : 0.f, i == w[3] ? v.w : 0.f);
  store4<kVec>(dense + f, d, ls);
  store4<kVec>(resid + f,
               make_float4(__fsub_rn(v.x, d.x), __fsub_rn(v.y, d.y),
                           __fsub_rn(v.z, d.z), __fsub_rn(v.w, d.w)),
               ls);
}

// Block `rank` of cluster cl = j (32 / lw) + slice holds rows [rank L,
// min(g, rank L + L)) of tile j's lanes [4 lw slice, 4 lw slice + 4 lw);
// its thread (s, q) (tid = lw s + q) the rows rank L + s + k S of 4 of
// those lanes (see load4), S = blockDim.x / lw.
template <bool kWithE, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 2)  // <= 64 registers
roundtrip_kernel(const float* __restrict__ x, const float* __restrict__ e,
                 float* __restrict__ dense, float* __restrict__ resid, int g,
                 int lw, int C, int L) {
  extern __shared__ float4 sm[];
  const int lws = __ffs(lw) - 1;  // lw and 32 / lw are powers of 2
  const int S = blockDim.x >> lws, s = threadIdx.x >> lws;
  const int q = threadIdx.x & (lw - 1);
  const int rank = C > 1 ? cluster_rank() : 0;
  const int cl = C > 1 ? cluster_id() : (int)blockIdx.x;
  const int j = cl >> (5 - lws), slice = cl & ((32 >> lws) - 1);
  // the thread's lanes: 4q .. 4q + 3 of the slice, or q + k lw (kVec off)
  const int ls = kVec ? 1 : lw;
  const int base = j * g * kTileLanes + 4 * slice * lw + (kVec ? 4 * q : q);
  const int r0 = rank * L + s, r1 = min(g, rank * L + L);
  if (C > 1) cluster_arrive_relaxed();
  stamp(0);
  float4 v[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = r0 + k * S;
    v[k] = i < r1 ? load_v<kWithE, kVec>(x, e, base + i * kTileLanes, ls)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  Best<false> b[4] = {none<false>(g), none<false>(g), none<false>(g),
                      none<false>(g)};
#pragma unroll
  for (int k = 0; k < kRows; ++k) scan4(b, v[k], r0 + k * S, r0 + k * S < r1);
  // rows past the registers' share: scanned now, read again below
  for (int i = r0 + kRows * S; i < r1; i += S)
    scan4(b, load_v<kWithE, kVec>(x, e, base + i * kTileLanes, ls), i);
  stamp(1, b[0].m + b[3].m);
  const float4* win = combine(b, lw, C, rank, sm);
  stamp(2);
  int w[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) w[l] = winner(unpack<false>(win[4 * q + l]), g);
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = r0 + k * S;
    if (i < r1)
      write4<kVec>(dense, resid, base + i * kTileLanes, ls, v[k], i, w);
  }
  for (int i = r0 + kRows * S; i < r1; i += S)
    write4<kVec>(dense, resid, base + i * kTileLanes, ls,
                 load_v<kWithE, kVec>(x, e, base + i * kTileLanes, ls), i, w);
  stamp(3);
}

// dynamic shared memory above 48 KB and clusters above 8, once a device
template <typename K>
int allow_big(K kernel, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = 1u << (dev & 31);
  if (done.load() & bit) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  done.fetch_or(bit);
  return 0;
}

// grid blocks in clusters of C along x (no cluster attribute for C = 1)
template <typename... P, typename... A>
int launch(void (*kernel)(P...), std::atomic<unsigned>& done, unsigned grid,
           int threads, int C, int groups, cudaStream_t stream, A... args) {
  const int smem = (threads / 32 + C + 1) * groups * 16;
  if (smem > 48 * 1024 || C > 8) {
    const int err = allow_big(kernel, done);
    if (err != 0) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// a plan the kernels take: whole warps, at most kMaxThreads, clusters of
// 1..16 whose C blocks of L rows cover `height` rows
bool plan_ok(int threads, int width, int C, int L, int height) {
  return threads > 0 && threads <= kMaxThreads && threads % 32 == 0 &&
         threads % width == 0 && C >= 1 && C <= kMaxCluster && L >= 1 &&
         (long long)C * L >= height;
}

std::atomic<unsigned> select_done;        // a bit per device: attributes set
std::atomic<unsigned> roundtrip_done[4];  // (static: zero at load)

}  // namespace

// x: (block, rows) f32; local: rows int32; vals: rows f32; slots at flat
// index >= n never win (rows <= n <= block * rows). Plan
// (ops/topk_kernels.py select_plan): clusters of C blocks of `threads`,
// each holding L rows of 32 lanes. Returns a cudaError_t.
extern "C" int bps_topk_select(const void* x, void* local, void* vals,
                               int block, int rows, long long n, int C, int L,
                               int threads, void* stream) {
  if (rows == 0) return 0;
  if (!plan_ok(threads, 32, C, L, block)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((rows + 31) / 32) * C;
  return launch(select_kernel, select_done, grid, threads, C, 32,
                static_cast<cudaStream_t>(stream),
                static_cast<const float*>(x), static_cast<int*>(local),
                static_cast<float*>(vals), block, rows, (int)(n / rows),
                (int)(n % rows), C, L);
}

// locals, vals: (K, rows) int32 / f32; out: (block, rows) f32. Plan
// (ops/topk_kernels.py reconstruct_plan): stripes of R rows, blocks of
// `threads` (one 128-column slice a warp), at most 65,535 blocks of
// stripes; vec: rows % 4 == 0 and every pointer 16-byte aligned. K >= 1.
extern "C" int bps_topk_reconstruct_sum(const void* locals, const void* vals,
                                        void* out, int K, int block, int rows,
                                        int R, int threads, int vec,
                                        void* stream) {
  if (rows == 0 || block == 0) return 0;
  if (K < 1 || R < 1 || R > kReconRows || threads < 32 ||
      threads > kReconMaxThreads || threads % 32 != 0 ||
      (vec && rows % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const int slices = (rows + kTileLanes - 1) / kTileLanes, W = threads / 32;
  const int stripes = (int)(((long long)block + R - 1) / R);
  const dim3 grid((slices + W - 1) / W, stripes < 65535 ? stripes : 65535);
  auto s = static_cast<cudaStream_t>(stream);
  auto lp = static_cast<const int*>(locals);
  auto vp = static_cast<const float*>(vals);
  auto op = static_cast<float*>(out);
  if (vec)
    reconstruct_sum_kernel<true><<<grid, threads, 0, s>>>(lp, vp, op, K,
                                                          block, rows, R);
  else
    reconstruct_sum_kernel<false><<<grid, threads, 0, s>>>(lp, vp, op, K,
                                                           block, rows, R);
  return (int)cudaGetLastError();
}

// x, e (may be null), dense, resid: J * g * 128 f32. Plan
// (ops/topk_kernels.py roundtrip_plan): clusters of C blocks of `threads`,
// each holding L rows of 4 lw lanes of a tile; vec: every pointer is
// 16-byte aligned.
extern "C" int bps_topk_roundtrip(const void* x, const void* e, void* dense,
                                  void* resid, int J, int g, int lw, int C,
                                  int L, int threads, int vec, void* stream) {
  if (J == 0 || g == 0) return 0;
  if (!(lw == 4 || lw == 8 || lw == 16 || lw == 32) ||
      !plan_ok(threads, lw, C, L, g))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)J * (32 / lw) * C;
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto ep = static_cast<const float*>(e);
  auto dp = static_cast<float*>(dense);
  auto rp = static_cast<float*>(resid);
  const int groups = 4 * lw;
  if (e != nullptr && vec)
    return launch(roundtrip_kernel<true, true>, roundtrip_done[0], grid,
                  threads, C, groups, s, xp, ep, dp, rp, g, lw, C, L);
  if (e != nullptr)
    return launch(roundtrip_kernel<true, false>, roundtrip_done[1], grid,
                  threads, C, groups, s, xp, ep, dp, rp, g, lw, C, L);
  if (vec)
    return launch(roundtrip_kernel<false, true>, roundtrip_done[2], grid,
                  threads, C, groups, s, xp, ep, dp, rp, g, lw, C, L);
  return launch(roundtrip_kernel<false, false>, roundtrip_done[3], grid,
                threads, C, groups, s, xp, ep, dp, rp, g, lw, C, L);
}

#ifdef BPS_TOPK_STAMPS
// the first n blocks' stamps, 4 a block, into host memory
extern "C" int bps_topk_read_stamps(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, stamps,
                                   sizeof(unsigned long long) * 4 *
                                       (n < kStampBlocks ? n : kStampBlocks));
}
#endif

extern "C" const char* bps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
