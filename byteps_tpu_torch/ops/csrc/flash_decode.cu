// Flash-decode for Hopper (sm_90a): single-token cached attention, f32
// and bf16, over a dense cache or an int8 cache with f32 scales.
//
// Replaces byteps_tpu/ops/flash_decode.py:_decode_kernel (launched by
// _decode): the query of each sequence, at global position pos, attends
// to the cached keys 0..pos; keys past pos are never read. int8 entries
// dequantize on load exactly as the reference does: f32(q) * scale,
// rounded to the model dtype, then widened to f32. Scores, p and the
// accumulation are f32; o comes out in the model dtype.
//
// Layouts (all contiguous): q, o (B, Hkv, G, D), the (B, 1, H, D) query
// viewed group-major (H = Hkv * G); k, v (B, S, Hkv, D) in the model
// dtype or int8; k_scale, v_scale (B, S, Hkv) f32.
//
// What bounds it. Decoding reads the live cache once per token and does
// 4 * D FLOPs per (query head, key): at G query heads per kv head that is
// about 2 * G FLOPs per cache byte in bf16, far below the ~295 an H100
// needs before arithmetic is the limit. So the bytes of the live cache,
// against 3.35 TB/s, bound it, and at the serving tier's batches (4-8
// sequences, 16 kv heads: 64-128 (sequence, kv head) pairs) so does the
// number of blocks that can keep those bytes in flight.
//
// Design. The live prefix is cut into n_split splits of split_tiles
// 32-key tiles each (the last one short), on a plan the caller computes
// from the live length, the batch, the kv heads, the SM count and the
// most splits that fit (bps_flash_decode_max_splits), so the grid (kv
// head, sequence, split) fills the card. A block's warps take the tiles
// of its split in turn (warp w: tiles w, w + nw, ...). Each warp copies
// its tiles into a ring of BUFS shared buffers with cp.async (16-byte
// vectors, the raw cache entries and their scales), BUFS - 1 tiles
// ahead of the one it folds, so a tile's loads are in flight behind the
// previous tiles' arithmetic: two buffers, or one where two do not fit
// (f32 rows of 256 beside a wide GQA group's state). The G query heads
// of the group each fold the staged tile once, into an online-softmax
// state kept in shared memory per (warp, head), widening (and
// dequantizing) the entries as they are read. At the end the block
// merges its warps' states by their row maxima, in warp order. With one
// split it writes o. Otherwise the n_split blocks of a (sequence, kv
// head) form one thread block cluster: each stores its partial state
// (m, l, acc) into its own slot of split 0's shared memory through
// distributed shared memory, arrives on the cluster barrier and exits;
// split 0 waits on the barrier, combines the slots in split order and
// writes o. No workspace, no second kernel, no atomics: a merge through
// device memory (a second kernel, or a ticket that lets the pair's last
// block merge) adds round trips through L2, and on an H100 both took
// longer than this one at every decode shape tried, as did split 0
// reading the others' shared memory while they wait. Sums run in a
// fixed order and each element has one writer, so the result is
// deterministic.
#include <algorithm>
#include <atomic>
#include <type_traits>

#include "attn_common.cuh"

namespace {

using namespace bps;

constexpr int kMaxWarps = 4;
constexpr int kMaxSplits = 16;         // the largest cluster
constexpr size_t kSmemCap = 200 * 1024;
constexpr size_t kTwoBlocks = 113 * 1024;   // two blocks an SM

// Bytes of a staged cache row: whole 16-byte chunks, an odd number of
// them, so the eight lanes of a quarter-warp reading eight rows' chunks
// with 16-byte loads hit eight different bank groups.
__host__ __device__ __forceinline__ int row_bytes(int D, int esz) {
  const int chunks = (D * esz + 15) / 16;
  return 16 * (chunks | 1);
}

// One staged tile: k rows [kTileKeys][rs], v rows the same, then (int8
// caches) the k and v scales [kTileKeys] f32.
__host__ __device__ __forceinline__ int tile_bytes(int rs, bool quant) {
  return 2 * kTileKeys * rs + (quant ? 2 * kTileKeys * 4 : 0);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// One warp starts the copy of n cache rows of k and v (row r of each at
// src + r * stride elements; scales, for int8, at sc + r * sstride) into
// the staged tile at dst. vec: the rows are 16-byte vectors and aligned
// on 16 bytes, so every byte moves by cp.async; otherwise the entries are
// copied by plain loads and stores, done when this returns.
template <typename C>
__device__ __forceinline__ void copy_tile(uint8_t* dst, const C* ksrc,
                                          const C* vsrc, const float* ksc,
                                          const float* vsc, int64_t stride,
                                          int sstride, int n, int D, int rs,
                                          bool vec, int lane) {
  uint8_t* kd = dst;
  uint8_t* vd = dst + kTileKeys * rs;
  float* scd = reinterpret_cast<float*>(dst + 2 * kTileKeys * rs);
  if (vec) {
    constexpr int E = 16 / sizeof(C);
    const int cpr = D / E, total = n * cpr;
    for (int c = lane; c < total; c += 32) {
      const int r = c / cpr, cc = c - r * cpr;
      cp_async16(kd + r * rs + cc * 16, ksrc + r * stride + cc * E);
      cp_async16(vd + r * rs + cc * 16, vsrc + r * stride + cc * E);
    }
  } else {
    for (int idx = lane; idx < n * D; idx += 32) {
      const int r = idx / D, d = idx - r * D;
      reinterpret_cast<C*>(kd + r * rs)[d] = ksrc[r * stride + d];
      reinterpret_cast<C*>(vd + r * rs)[d] = vsrc[r * stride + d];
    }
  }
  if (ksc != nullptr && lane < n) {
    cp_async4(scd + lane, ksc + (int64_t)lane * sstride);
    cp_async4(scd + kTileKeys + lane, vsc + (int64_t)lane * sstride);
  }
}

// One warp folds a staged tile of n keys into one query head's
// online-softmax state (fold_rows' arithmetic for one row, reading the
// raw entries): lane j scores key j, reading its row in 16-byte vectors
// in column order against the query row (16-byte aligned); lane i owns
// output columns i, i + 32, ... of acc.
template <typename T, typename C, int DMAX>
__device__ __forceinline__ void fold_tile(const float* __restrict__ qrow,
                                          const uint8_t* __restrict__ tile,
                                          int rs, int D, int n, float scale,
                                          float& m, float& l,
                                          float (&acc)[DMAX / 32]) {
  constexpr bool quant = std::is_same<C, int8_t>::value;
  constexpr int E = 16 / sizeof(C);
  const int lane = threadIdx.x & 31;
  const uint8_t* vt = tile + kTileKeys * rs;
  const float* ksc = reinterpret_cast<const float*>(tile + 2 * kTileKeys * rs);
  const float* vsc = ksc + kTileKeys;
  float dot = 0.f;
  if (lane < n) {
    const uint8_t* kr = tile + lane * rs;
    const float sk = quant ? ksc[lane] : 1.f;
    int d = 0;
    for (; d + E <= D; d += E) {
      const uint4 u = *reinterpret_cast<const uint4*>(kr + d * sizeof(C));
      const C* e = reinterpret_cast<const C*>(&u);
#pragma unroll
      for (int i = 0; i < E; i += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + d + i);
        dot = fmaf(qv.x, widen<T, C>(e[i], sk), dot);
        dot = fmaf(qv.y, widen<T, C>(e[i + 1], sk), dot);
        dot = fmaf(qv.z, widen<T, C>(e[i + 2], sk), dot);
        dot = fmaf(qv.w, widen<T, C>(e[i + 3], sk), dot);
      }
    }
    for (; d < D; ++d)
      dot = fmaf(qrow[d], widen<T, C>(reinterpret_cast<const C*>(kr)[d], sk),
                 dot);
  }
  const float s = lane < n ? dot * scale : kNeg;
  float mx = s;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  mx = fmaxf(m, mx);
  const float p = (s > 0.5f * kNeg) ? expf(s - mx) : 0.f;
  float sum = p;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  const float alpha = expf(m - mx);
  l = l * alpha + sum;
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i) acc[i] *= alpha;
  m = mx;
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const float pj = __shfl_sync(kFull, p, j);
    const C* vr = reinterpret_cast<const C*>(vt + j * rs);
    const float sv = quant ? vsc[j] : 1.f;
#pragma unroll
    for (int i = 0; i < DMAX / 32; ++i) {
      const int d = lane + 32 * i;
      if (d < D) acc[i] = fmaf(pj, widen<T, C>(vr[d], sv), acc[i]);
    }
  }
}

// the row stride of the staged query rows: a whole number of float4s
__host__ __device__ __forceinline__ int q_ld(int D) { return (D + 3) & ~3; }

// q [G][q_ld] f32, the warps' states [nw][G][D + 2] (m, l, acc), then
// (with n_split > 1) the splits' slots [n_split][G][D + 2], on 16 bytes
__host__ __device__ __forceinline__ size_t head_bytes(int nw, int G, int D,
                                                      int n_split) {
  const size_t slots = n_split > 1 ? (size_t)n_split * G * (D + 2) : 0;
  return ((size_t)4 * ((size_t)G * q_ld(D) + (size_t)nw * G * (D + 2) +
                       slots) +
          15) & ~(size_t)15;
}

size_t smem_bytes(int nw, int G, int D, int esz, bool quant, int n_split,
                  int bufs) {
  // then `bufs` staged tiles a warp
  return head_bytes(nw, G, D, n_split) +
         (size_t)nw * bufs * tile_bytes(row_bytes(D, esz), quant);
}

// Launched with n_split > 1 in clusters of (1, 1, n_split) blocks: the
// cluster spans the grid's z, so split s is cluster block s.
template <typename T, typename C, int DMAX, int BUFS>
__global__ void __launch_bounds__(kMaxWarps * 32)
decode_kernel(const T* __restrict__ q, const C* __restrict__ k,
              const C* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, T* __restrict__ o, int S,
              int Hkv, int G, int D, int live, int split_tiles, float scale) {
  constexpr bool quant = std::is_same<C, int8_t>::value;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int st_ld = D + 2;                      // m, l, acc[D]
  const int qld = q_ld(D);
  const int rs = row_bytes(D, sizeof(C)), tb = tile_bytes(rs, quant);
  float* qs = smem;                             // [G][qld]
  float* st = qs + G * qld;                     // [nw][G][st_ld]
  float* slots = st + nw * G * st_ld;           // [n_split][G][st_ld]
  float* my = st + warp * G * st_ld;
  uint8_t* mine = reinterpret_cast<uint8_t*>(smem) +
                  head_bytes(nw, G, D, gridDim.z) +
                  (size_t)warp * BUFS * tb;     // this warp's ring

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  // a cluster's blocks store into split 0's shared memory only once
  // every block of it has started: the first barrier phase says so
  if (gridDim.z > 1) cluster_arrive_relaxed();
  const int ntiles = (live + kTileKeys - 1) / kTileKeys;
  const int t_end = min(ntiles, (split + 1) * split_tiles);
  const int64_t kv_pos = (int64_t)Hkv * D;      // stride between keys
  const bool vec = (D * (int)sizeof(C)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(k) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  auto issue = [&](int t, int bi) {
    const int k0 = t * kTileKeys;
    const int64_t row0 = ((int64_t)b * S + k0) * Hkv + hk;  // key k0's row
    copy_tile<C>(mine + bi * tb, k + row0 * D, v + row0 * D,
                 quant ? k_scale + row0 : nullptr,
                 quant ? v_scale + row0 : nullptr, kv_pos, Hkv,
                 min(kTileKeys, live - k0), D, rs, vec, lane);
    cp_async_commit();
  };

  // the warp's tiles t0, t0 + nw, ...: the first BUFS - 1 are in
  // flight while the block reads q (an empty group where a warp has
  // fewer, so every wait below counts the same groups)
  const int t0 = split * split_tiles + warp;
  const int n_my = t0 < t_end ? (t_end - t0 + nw - 1) / nw : 0;
#pragma unroll
  for (int j = 0; j < BUFS - 1; ++j) {
    if (j < n_my)
      issue(t0 + j * nw, j);
    else
      cp_async_commit();
  }
  const int64_t head0 = ((int64_t)b * Hkv + hk) * G * D;  // q/o offset
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x)
    qs[idx / D * qld + idx % D] = to_f32(q[head0 + idx]);
  for (int idx = lane; idx < G * st_ld; idx += 32)
    my[idx] = (idx % st_ld == 0) ? kNeg : 0.f;
  __syncthreads();

  for (int i = 0; i < n_my; ++i) {
    const int ahead = i + BUFS - 1;    // refills the buffer folded last
    if (ahead < n_my)
      issue(t0 + ahead * nw, ahead % BUFS);
    else
      cp_async_commit();
    cp_async_wait<BUFS - 1>();         // tile i's copies have landed
    __syncwarp();
    const uint8_t* tile = mine + (i % BUFS) * tb;
    const int n = min(kTileKeys, live - (t0 + i * nw) * kTileKeys);
    for (int g = 0; g < G; ++g) {
      float* sg = my + g * st_ld;
      float m = sg[0], l = sg[1];
      float acc[DMAX / 32];
#pragma unroll
      for (int c = 0; c < DMAX / 32; ++c) {
        const int d = lane + 32 * c;
        acc[c] = d < D ? sg[2 + d] : 0.f;
      }
      fold_tile<T, C, DMAX>(qs + g * qld, tile, rs, D, n, scale, m, l, acc);
#pragma unroll
      for (int c = 0; c < DMAX / 32; ++c) {
        const int d = lane + 32 * c;
        if (d < D) sg[2 + d] = acc[c];
      }
      __syncwarp();  // every lane has read m, l before lane 0 rewrites them
      if (lane == 0) {
        sg[0] = m;
        sg[1] = l;
      }
    }
    __syncwarp();    // the tile is folded before the next copy reuses it
  }
  __syncthreads();

  // merge the warps' partial states in warp order, one query head per
  // warp at a time; then o, or this split's slot in split 0
  if (gridDim.z > 1) cluster_wait();
  for (int g = warp; g < G; g += nw) {
    float mx = kNeg;
    for (int w = 0; w < nw; ++w) mx = fmaxf(mx, st[(w * G + g) * st_ld]);
    float l = 0.f, acc[DMAX / 32];
#pragma unroll
    for (int i = 0; i < DMAX / 32; ++i) acc[i] = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float* sw = st + (w * G + g) * st_ld;
      const float a = expf(sw[0] - mx);
      l += sw[1] * a;
#pragma unroll
      for (int i = 0; i < DMAX / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] += sw[2 + d] * a;
      }
    }
    if (gridDim.z == 1) {
      const float l_safe = l > 0.f ? l : 1.f;
#pragma unroll
      for (int i = 0; i < DMAX / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < D)
          o[head0 + (int64_t)g * D + d] = from_f32<T>(acc[i] / l_safe);
      }
    } else {
      float* pg = slots + ((int64_t)split * G + g) * st_ld;
#pragma unroll
      for (int i = 0; i < DMAX / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < D) st_cluster(pg + 2 + d, 0, acc[i]);
      }
      if (lane == 0) {
        st_cluster(pg, 0, mx);
        st_cluster(pg + 1, 0, l);
      }
    }
  }
  if (gridDim.z == 1) return;

  // split 0 combines the slots in split order: one pass, rescaling the
  // running state to each new maximum. The others exit once they have
  // arrived on the second phase (nothing reads their shared memory).
  cluster_arrive();
  if (split != 0) return;
  cluster_wait();
  for (int g = warp; g < G; g += nw) {
    float mx = kNeg, l = 0.f, acc[DMAX / 32];
#pragma unroll
    for (int i = 0; i < DMAX / 32; ++i) acc[i] = 0.f;
    for (int s = 0; s < (int)gridDim.z; ++s) {
      const float* pg = slots + ((int64_t)s * G + g) * st_ld;
      const float mn = fmaxf(mx, pg[0]);
      const float old = expf(mx - mn), add = expf(pg[0] - mn);
      l = l * old + pg[1] * add;
#pragma unroll
      for (int i = 0; i < DMAX / 32; ++i) {
        const int d = lane + 32 * i;
        acc[i] = acc[i] * old + (d < D ? pg[2 + d] : 0.f) * add;
      }
      mx = mn;
    }
    const float l_safe = l > 0.f ? l : 1.f;
#pragma unroll
    for (int i = 0; i < DMAX / 32; ++i) {
      const int d = lane + 32 * i;
      if (d < D)
        o[head0 + (int64_t)g * D + d] = from_f32<T>(acc[i] / l_safe);
    }
  }
}

// Lift the kernel's dynamic shared memory limit to kSmemCap and allow
// clusters of up to kMaxSplits blocks, once per instantiation and device.
template <typename T, typename C, int DMAX, int BUFS>
int set_attributes() {
  static std::atomic<unsigned> done{0};   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = 1u << (dev & 31);
  if (done.load() & bit) return 0;
  err = cudaFuncSetAttribute(decode_kernel<T, C, DMAX, BUFS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemCap);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decode_kernel<T, C, DMAX, BUFS>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return (int)err;
  done.fetch_or(bit);
  return 0;
}

struct Plan {
  int live, n_split, split_tiles;
};

template <typename T, typename C, int DMAX, int BUFS>
int run(const void* q, const void* k, const void* v, const void* ks,
        const void* vs, void* o, int B, int S, int Hkv, int G, int D,
        const Plan& p, float scale, int nw, size_t smem,
        cudaStream_t stream) {
  const int err = set_attributes<T, C, DMAX, BUFS>();
  if (err != 0) return err;
  auto kern = decode_kernel<T, C, DMAX, BUFS>;
  if (p.n_split == 1) {   // nothing to merge: no cluster
    kern<<<dim3(Hkv, B), nw * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const C*>(k),
        static_cast<const C*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<T*>(o), S, Hkv, G, D,
        p.live, p.split_tiles, scale);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hkv, B, p.n_split);
  cfg.blockDim = dim3(nw * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = p.n_split;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const C*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<T*>(o), S, Hkv, G, D,
      p.live, p.split_tiles, scale);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, typename C, int DMAX>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, void* o, int B, int S, int Hkv, int G, int D,
           const Plan& p, float scale, cudaStream_t stream) {
  constexpr bool quant = std::is_same<C, int8_t>::value;
  auto bytes = [&](int w, int bufs) {
    return smem_bytes(w, G, D, sizeof(C), quant, p.n_split, bufs);
  };
  // two staged tiles a warp where they fit; as many warps as the
  // split's tiles can use and two blocks an SM allow (one at the widest)
  const int bufs = bytes(1, 2) <= kSmemCap ? 2 : 1;
  int nw = std::min(kMaxWarps, p.split_tiles);
  while (nw > 1 && bytes(nw, bufs) > kTwoBlocks) --nw;
  const size_t smem = bytes(nw, bufs);
  if (smem > kSmemCap) return (int)cudaErrorInvalidValue;
  if (bufs == 2)
    return run<T, C, DMAX, 2>(q, k, v, ks, vs, o, B, S, Hkv, G, D, p, scale,
                              nw, smem, stream);
  return run<T, C, DMAX, 1>(q, k, v, ks, vs, o, B, S, Hkv, G, D, p, scale,
                            nw, smem, stream);
}

template <typename T, typename C>
int dispatch_dim(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, void* o, int B, int S, int Hkv, int G, int D,
                 const Plan& p, float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, C, 64>(q, k, v, ks, vs, o, B, S, Hkv, G, D, p, scale,
                            stream);
  if (D <= 128)
    return launch<T, C, 128>(q, k, v, ks, vs, o, B, S, Hkv, G, D, p, scale,
                             stream);
  return launch<T, C, 256>(q, k, v, ks, vs, o, B, S, Hkv, G, D, p, scale,
                           stream);
}

template <typename T>
int dispatch_cache(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, void* o, int quant, int B, int S, int Hkv,
                   int G, int D, const Plan& p, float scale,
                   cudaStream_t stream) {
  if (quant)
    return dispatch_dim<T, int8_t>(q, k, v, ks, vs, o, B, S, Hkv, G, D, p,
                                   scale, stream);
  return dispatch_dim<T, T>(q, k, v, ks, vs, o, B, S, Hkv, G, D, p, scale,
                            stream);
}

}  // namespace

// The most splits (at most 16) whose partial states fit split 0's shared
// memory beside one warp's single staged tile, for G query heads a kv
// head of dim D over cache entries of esz bytes (quant: int8 with
// scales); 1 when even those do not, which bps_flash_decode then refuses.
extern "C" int bps_flash_decode_max_splits(int G, int D, int esz,
                                           int quant) {
  int n = kMaxSplits;
  while (n > 1 && smem_bytes(1, G, D, esz, quant != 0, n, 1) > kSmemCap) --n;
  return n;
}

// dtype (of q, o and a dense cache): 0 = float32, 1 = bfloat16. quant: the
// cache is int8 and k_scale / v_scale are given. pos: the query's global
// position (0 <= pos < S). The split plan: n_split (at most
// bps_flash_decode_max_splits) splits of split_tiles 32-key tiles cover
// the live prefix 0..pos, every split holding at least one live key;
// split 0 holds n_split * G * (D + 2) f32 of slots in shared memory.
// scale = 1/sqrt(D) rounded to f32 by the
// caller. Returns a cudaError_t (0 = success). The Python wrapper has
// checked shapes, dtypes, devices and contiguity.
extern "C" int bps_flash_decode(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                void* o, int dtype, int quant, int B, int S,
                                int Hkv, int G, int D, int pos, int n_split,
                                int split_tiles, float scale, void* stream) {
  if (B == 0 || Hkv == 0 || G == 0) return 0;
  const int live = std::min(pos + 1, S);
  const int ntiles = (live + kTileKeys - 1) / kTileKeys;
  if (n_split < 1 || n_split > kMaxSplits || split_tiles < 1 ||
      (n_split - 1) * split_tiles >= ntiles ||
      (long long)n_split * split_tiles < ntiles)
    return (int)cudaErrorInvalidValue;
  const Plan p{live, n_split, split_tiles};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_cache<__nv_bfloat16>(q, k, v, k_scale, v_scale, o, quant,
                                         B, S, Hkv, G, D, p, scale, s);
  return dispatch_cache<float>(q, k, v, k_scale, v_scale, o, quant, B, S, Hkv,
                               G, D, p, scale, s);
}
