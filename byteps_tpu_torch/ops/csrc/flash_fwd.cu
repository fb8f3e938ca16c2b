// Flash-attention forward for Hopper (sm_90a), f32 and bf16.
//
// Replaces byteps_tpu/ops/flash_attention.py:_fwd_kernel (launched by
// _fwd): softmax attention with global-offset causal masking, GQA by
// head index, o in the input dtype and the per-row logsumexp in f32.
//
// Layouts (all contiguous): q, o (B, Sq, H, D); k, v (B, Sk, Hkv, D);
// lse (B, Sq, H). Query row i sits at global position q_off + i, key j at
// k_off + j; with causal set, key j is live for row i iff
// q_off + i >= k_off + j. A row with no live key gets o = 0, lse = -1e30.
//
// Design. The keys are cut into splits of kSplitKeys, counted from key 0.
// One block per (b*h, 16-row query tile, split): four warps of four rows
// each. The block walks the 32-key tiles of its split in order (the loop
// that replaces the TPU's sequential nk grid axis), staging k and v in
// shared memory as f32 (read through the GQA map h -> h / (H / Hkv),
// 16-byte vector loads all in flight at once), and each warp folds the
// tile into the online-softmax state (m, l, acc) of its four rows at
// once, held in registers. Tiles past the last live key of the block
// are never loaded; within a tile each row stops at its own last live
// key, which is also how the ragged edge of Sk is masked. When the live
// keys span one split the block writes o and lse itself; otherwise each
// block writes its rows' partial state to a workspace and merge_kernel
// combines a row's splits in order. A row's result depends only on its
// own live keys, never on the grid: splits start at fixed keys, and a
// split with no live key for a row is never read for it. bf16 grids of
// at least kMmaMinBlocks 64-row tiles (training, long prefills) take the
// tensor-core path at the end of this file instead: no splits, p rounded
// to bf16 for the PV product.
//
// What bounds it. At the prefill shapes of GPT-2 medium (D = 64, at most
// a few thousand keys) the q/k/v bytes are small and the work is
// 4 * D FLOPs per live (row, key) pair. This kernel does that work in
// f32 FMAs on the CUDA cores (67 TFLOP/s peak on an H100 SXM), not on
// the tensor cores (989 TFLOP/s bf16). On a serving chunk (32 rows
// against up to 1024 keys) the grid, not the arithmetic, was the limit:
// B*H*2 blocks on 132 SMs, each walking every key tile in turn. The
// splits give such a chunk one block per 128 keys, and the four rows of
// a warp share each key load, so a tile costs one pass of independent
// FMA chains instead of four dependent ones. At GPT-2 medium's training
// shape (B*H = 128, S = 1024) the split path wrote a 277 MB workspace
// for the merge; the tensor-core path needs none. There bytes and work
// balance: 67 MB of q, k, v and o (0.020 ms a layer at 3.35 TB/s) and
// 17 GFLOP (4 * D a live pair, 0.017 ms at 989 TFLOP/s bf16). Only
// wgmma reaches that rate on Hopper, and only fed by tiles that arrive
// while the previous ones are multiplied: the path streams k and v by
// TMA through a ring that a producer warp keeps full, so no copy waits
// on the math or the math on a copy, and the blocks persist, so one
// item's start and end overlap the next one's copies. What it still
// pays: one exponential a live pair, and at D = 64 the MUFU unit's 16 a
// clock an SM take as long as the pair's 256 FLOPs on the tensor cores;
// and a warpgroup's softmax waits on its own products, overlapping only
// the other warpgroup's.
#include <algorithm>
#include <cmath>

#include "attn_common.cuh"
#include "hopper.cuh"

namespace {

using namespace bps;

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kSplitKeys = 4 * kTileKeys;   // keys per split

// one past the last key live for query row qi
__host__ __device__ __forceinline__ int live_end(int qi, int Sk, int q_off,
                                                 int k_off, int causal) {
  if (!causal) return Sk;
  const int e = q_off + qi - k_off + 1;
  return e < 0 ? 0 : (e < Sk ? e : Sk);
}

int num_splits(int Sq, int Sk, int q_off, int k_off, int causal) {
  const int kend = live_end(Sq - 1, Sk, q_off, k_off, causal);
  return std::max(1, (kend + kSplitKeys - 1) / kSplitKeys);
}

// ws, when the grid has more than one split: [splits][rows][2] (m, l)
// then [splits][rows][D] acc, rows = B * Sq * H in (b, i, h) order.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kWarps * 32)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
           float* __restrict__ ws, int Sq, int Sk, int H, int Hkv, int D,
           int q_off, int k_off, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = tile_ld(D);
  float* qs = smem;                    // [kBQ][D]
  float* ks = qs + kBQ * D;            // [kTileKeys][ld]
  float* vs = ks + kTileKeys * ld;     // [kTileKeys][ld]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int split = blockIdx.z, k_lo = split * kSplitKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // keys [k_lo, kend) of this split are live for at least one row
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int kend = min(live_end(q_last, Sk, q_off, k_off, causal),
                       k_lo + kSplitKeys);
  if (gridDim.z > 1 && kend <= k_lo) return;  // no row reads this split

  const int64_t q_pos = (int64_t)H * D;     // stride between positions
  const int64_t kv_pos = (int64_t)Hkv * D;
  const T* qb = q + (int64_t)b * Sq * q_pos + (int64_t)h * D;
  const T* kb = k + (int64_t)b * Sk * kv_pos + (int64_t)hk * D;
  const T* vb = v + (int64_t)b * Sk * kv_pos + (int64_t)hk * D;

  const float* const no_scale[2] = {nullptr, nullptr};
  {
    const int nq = min(kBQ, Sq - q0);  // rows past Sq stay zero
    float* const dst[1] = {qs};
    const T* const src[1] = {qb + (int64_t)q0 * q_pos};
    const float* const sc[1] = {nullptr};
    stage_rows<T, T, kWarps * 32, 1>(dst, D, src, q_pos, sc, 0, nq, D,
                                     threadIdx.x);
    for (int idx = nq * D + threadIdx.x; idx < kBQ * D; idx += blockDim.x)
      qs[idx] = 0.f;
  }

  int row_end[kRowsPerWarp];  // one past this split's last live key, per row
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DMAX / 32];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    row_end[rr] = qi < Sq ? min(live_end(qi, Sk, q_off, k_off, causal),
                                k_lo + kSplitKeys)
                          : 0;
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DMAX / 32; ++i) acc[rr][i] = 0.f;
  }

  for (int k0 = k_lo; k0 < kend; k0 += kTileKeys) {
    const int n = min(kTileKeys, kend - k0);
    __syncthreads();  // the previous tile is consumed (and qs is written)
    float* const dst[2] = {ks, vs};
    const T* const src[2] = {kb + k0 * kv_pos, vb + k0 * kv_pos};
    stage_rows<T, T, kWarps * 32, 2>(dst, ld, src, kv_pos, no_scale, 0, n, D,
                                     threadIdx.x);
    __syncthreads();
    int n_live[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
      n_live[rr] = min(n, row_end[rr] - k0);
    fold_rows<kRowsPerWarp, DMAX>(qs + warp * kRowsPerWarp * D, ks, vs, ld, D,
                                  n_live, scale, m, l, acc);
  }

  const int64_t rows = (int64_t)gridDim.x * Sq;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    if (qi >= Sq) continue;
    const int64_t row = ((int64_t)b * Sq + qi) * H + h;
    if (gridDim.z == 1) {
      const float l_safe = l[rr] > 0.f ? l[rr] : 1.f;
#pragma unroll
      for (int i = 0; i < DMAX / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < D) o[row * D + d] = from_f32<T>(acc[rr][i] / l_safe);
      }
      if (lane == 0) lse[row] = l[rr] > 0.f ? m[rr] + logf(l_safe) : kNeg;
    } else if (row_end[rr] > k_lo) {  // merge_kernel reads this split
      const int64_t at = (int64_t)split * rows + row;
      float* wacc = ws + 2 * (int64_t)gridDim.z * rows + at * D;
#pragma unroll
      for (int i = 0; i < DMAX / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < D) wacc[d] = acc[rr][i];
      }
      if (lane == 0) {
        ws[2 * at] = m[rr];
        ws[2 * at + 1] = l[rr];
      }
    }
  }
}

// One warp per row: combine the partial states of the row's live splits,
// in split order, and write o and lse. A row with one live split gets
// exactly what fwd_kernel writes without a workspace (its scale factor is
// exp(0) = 1); a row with none gets o = 0, lse = -1e30.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kWarps * 32)
merge_kernel(const float* __restrict__ ws, T* __restrict__ o,
             float* __restrict__ lse, int64_t rows, int n_split, int Sq,
             int Sk, int H, int D, int q_off, int k_off, int causal) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int qi = (int)((row / H) % Sq);
  const int live = (live_end(qi, Sk, q_off, k_off, causal) + kSplitKeys - 1) /
                   kSplitKeys;
  const float* wacc = ws + 2 * (int64_t)n_split * rows;
  float mx = kNeg;
  for (int s = 0; s < live; ++s) mx = fmaxf(mx, ws[2 * (s * rows + row)]);
  float l = 0.f, acc[DMAX / 32];
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i) acc[i] = 0.f;
  for (int s = 0; s < live; ++s) {
    const int64_t at = s * rows + row;
    const float a = expf(ws[2 * at] - mx);
    l += ws[2 * at + 1] * a;
#pragma unroll
    for (int i = 0; i < DMAX / 32; ++i) {
      const int d = lane + 32 * i;
      if (d < D) acc[i] += wacc[at * D + d] * a;
    }
  }
  const float l_safe = l > 0.f ? l : 1.f;
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i) {
    const int d = lane + 32 * i;
    if (d < D) o[row * D + d] = from_f32<T>(acc[i] / l_safe);
  }
  if (lane == 0) lse[row] = l > 0.f ? mx + logf(l_safe) : kNeg;
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16 at D = 64 or 128 when the query tiles alone fill
// the card (B * H * ceil(Sq / 64) >= kMmaMinBlocks): training and long
// prefills. No splits; p is rounded to bf16 for the PV product, as the
// reference's kernel rounds it for its MXU, and l sums the unrounded p.
// Short chunks (the serving tier's) keep the split path above, which
// spreads one chunk's keys over blocks; f32 always takes it.
//
// A block is persistent: at most one an SM, each taking a fixed list of
// items (one head's 128 query rows; hopper.cuh's Items). It has two consumer
// warpgroups of 64 rows and one producer warp, whose one thread issues
// every copy. The producer copies an item's query rows to one of two
// shared buffers and streams the k and v tiles of its live keys (128 keys
// a tile at D = 64, 64 at D = 128) through a ring of four stages by TMA,
// each stage and buffer with a "full" mbarrier (the copies' bytes landed)
// and an "empty" one (every consumer warp is done with it); it runs ahead
// across items, so the next item's rows and first tiles land while this
// one's last tiles and outputs are worked on. A consumer warpgroup runs
// s = q.k^T and o += p.v as wgmma from shared memory (p the register A
// operand, v read MN-major) and the online softmax between them in the
// accumulator layout: base 2, one FFMA and one MUFU op a key, the mask
// evaluated only on the tiles that cross its causal diagonal or the
// ragged edge of Sk. The two warpgroups' products and softmaxes overlap
// each other; within one they run in turn.
// ---------------------------------------------------------------------------
constexpr int kMmaRows = 64;         // the dispatch rule's query tile
constexpr int kMmaMinBlocks = 128;   // about one block per SM (132)

bool use_mma(int dtype, int aligned, int B, int Sq, int H, int D) {
  return dtype == 1 && aligned && (D == 64 || D == 128) &&
         (int64_t)B * H * ((Sq + kMmaRows - 1) / kMmaRows) >= kMmaMinBlocks;
}

constexpr float kLog2e = 1.4426950408889634f;

template <int D> struct FwdTiles {
  static constexpr int kSlabs = D / 64;
  // two consumer warpgroups of 64 query rows, then one producer warp
  static constexpr int kConsumers = 2;
  static constexpr int kBlockRows = kConsumers * hop::kTileRows;
  static constexpr int kThreads = kConsumers * 128 + 32;
  static constexpr int kKeyTile = D == 64 ? 128 : 64;   // keys a stage
  // a query buffer: [warpgroup][slab][64 rows][128 B]; two of them, so
  // the next item's rows land while this one's are in use
  static constexpr uint32_t kQBytes = kConsumers * kSlabs * hop::kSlabBytes;
  // one k (or v) tile: [slab][kKeyTile keys][128 B]; a stage holds k, v
  static constexpr uint32_t kKVSlab = kKeyTile * 128;
  static constexpr uint32_t kKVBytes = kSlabs * kKVSlab;
  static constexpr uint32_t kStageBytes = 2 * kKVBytes;
  static constexpr int kStages = 4;
  static constexpr uint32_t kKVOff = 2 * kQBytes;
  static constexpr uint32_t kBars = kKVOff + kStages * kStageBytes;
  // the barriers (q full and empty per buffer, then full and empty per
  // stage) and the slack that lets the tiles start on 1024 bytes
  static constexpr size_t kSmem = kBars + 8 * (4 + 2 * kStages) + hop::kAtom;
  static_assert(kSmem <= 227 * 1024, "one block an SM");
};

// s = q.k^T of the warpgroup's 64 rows against a key tile, issued and
// committed (not waited for)
template <int D, int KT = FwdTiles<D>::kKeyTile>
__device__ __forceinline__ void issue_s(float (&sc)[KT / 2], uint32_t qw,
                                        uint32_t ks) {
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) sc[i] = 0.f;
  hop::pin(sc);
  hop::wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hop::mma_ss<KT>(sc, hop::desc_k(qw, kk, hop::kSlabBytes),
                    hop::desc_k(ks, kk, FwdTiles<D>::kKVSlab), kk > 0);
  hop::wg_commit();
}

// o += p.v over a key tile, p the A fragments of its keys, issued and
// committed (not waited for)
template <int D, int KT = FwdTiles<D>::kKeyTile>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&ap)[KT / 16][4],
                                         uint32_t vs) {
  hop::pin(acc);
  hop::wg_fence();
#pragma unroll
  for (int j = 0; j < KT / 16; ++j)
    hop::mma_rs<D>(acc, ap[j], hop::desc_mn(vs, j, FwdTiles<D>::kKVSlab), 1);
  hop::wg_commit();
}

// The online softmax of one tile in place: s (raw q.k) becomes
// p = 2^((s - m_new) * scale_log2), one FFMA and one MUFU op a key; m
// (the raw row maximum, -inf before any live key) and l move to the
// tile's state, and alpha gets each row's rescale factor for o. MASKED
// tiles (some key lies at or past a row's end, lim[r] keys into the
// thread's columns) set those keys to -inf first; a row with no live key
// yet keeps p = 0 and l = 0.
template <int KT, bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&sc)[KT / 2],
                                             const int (&lim)[2],
                                             float scale_log2, float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    const int r = (i >> 1) & 1;
    if (MASKED && (i >> 2) * 8 + (i & 1) >= lim[r]) sc[i] = -INFINITY;
    mx[r] = fmaxf(mx[r], sc[i]);
  }
  float base[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    const float use = MASKED && mx[r] == -INFINITY ? 0.f : mx[r];
    alpha[r] = hop::ex2((m[r] - use) * scale_log2);
    base[r] = use * scale_log2;
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = hop::ex2(fmaf(sc[i], scale_log2, -base[r]));
    sum[r] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
    sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
    l[r] = l[r] * alpha[r] + sum[r];
  }
}

// The softmax of the tile from key k0 on, masked only where some key
// lies at or past a row's end (the rows' ends end_r; every row of the
// warpgroup keeps the keys below all_end)
template <int KT>
__device__ __forceinline__ void softmax_at(int k0, int all_end,
                                           const int (&end_r)[2], int t4,
                                           float (&sc)[KT / 2],
                                           float scale_log2, float (&m)[2],
                                           float (&l)[2], float (&alpha)[2]) {
  const int lim[2] = {end_r[0] - k0 - 2 * t4, end_r[1] - k0 - 2 * t4};
  if (k0 + KT > all_end)
    softmax_tile<KT, true>(sc, lim, scale_log2, m, l, alpha);
  else
    softmax_tile<KT, false>(sc, lim, scale_log2, m, l, alpha);
}

// p (f32, accumulator layout) rounded to bf16 as the A fragments of
// o += p.v: keys 16j.. of the tile in ap[j]
template <int KT>
__device__ __forceinline__ void pack_p(const float (&sc)[KT / 2],
                                       uint32_t (&ap)[KT / 16][4]) {
#pragma unroll
  for (int n = 0; n < KT / 8; ++n) {
    ap[n >> 1][(n & 1) * 2] = pack_bf16(sc[4 * n], sc[4 * n + 1]);
    ap[n >> 1][(n & 1) * 2 + 1] = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(FwdTiles<D>::kThreads, 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                 float* __restrict__ lse, int B, int Sq, int Sk, int H,
                 int Hkv, int q_off, int k_off, int causal, float scale_log2,
                 int group) {
  using T = FwdTiles<D>;
  constexpr int kKeyTile = T::kKeyTile, kConsumers = T::kConsumers;
  extern __shared__ uint8_t smem_tc[];
  const uint32_t base =
      (hop::saddr(smem_tc) + hop::kAtom - 1) & ~(hop::kAtom - 1);
  const uint32_t kv_s = base + T::kKVOff, bars = base + T::kBars;
  auto q_buf = [&](int it) { return base + (it & 1) * T::kQBytes; };
  auto q_full = [&](int it) { return bars + 8 * (it & 1); };
  auto q_empty = [&](int it) { return bars + 8 * (2 + (it & 1)); };
  auto full = [&](int t) { return bars + 8 * (4 + t % T::kStages); };
  auto empty = [&](int t) {
    return bars + 8 * (4 + T::kStages + t % T::kStages);
  };
  // the phase parity of the n-th use of a ring slot of `slots`
  auto parity = [](int n, int slots) { return (uint32_t)(n / slots) & 1; };

  const hop::Items items(Sq, B * H, group, T::kBlockRows);
  // one past the last key any row of query tile qt sees
  auto tile_end = [&](int qt) {
    return live_end(min((qt + 1) * T::kBlockRows, Sq) - 1, Sk, q_off, k_off,
                    causal);
  };
  const int wg = threadIdx.x / 128;   // kConsumers: the producer warp
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      hop::bar_init(q_full(i), 1);
      hop::bar_init(q_empty(i), kConsumers * 4);   // one arrival a warp
    }
    for (int s = 0; s < T::kStages; ++s) {
      hop::bar_init(full(s), 1);
      hop::bar_init(empty(s), kConsumers * 4);
    }
    hop::bar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread issues the copies, running ahead of the
    // consumers by the ring (and by a query buffer across items)
    if (threadIdx.x == kConsumers * 128) {
      int it = 0, t = 0;
      for (int r = 0; r < items.rounds(); ++r) {
        const int bh = items.head(r);
        if (bh >= items.n_bh) continue;
        const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
        const int qt = items.q_tile(r), q0 = qt * T::kBlockRows;
        if (it >= 2) hop::bar_wait(q_empty(it), parity(it, 2) ^ 1);
        hop::bar_arrive_tx(q_full(it), T::kQBytes);
        for (int w = 0; w < kConsumers; ++w)
          for (int sl = 0; sl < T::kSlabs; ++sl)
            hop::tma_load(q_buf(it) + (w * T::kSlabs + sl) * hop::kSlabBytes,
                          &tq, q_full(it), 64 * sl, h,
                          q0 + hop::kTileRows * w, b);
        const int n_tiles = (tile_end(qt) + kKeyTile - 1) / kKeyTile;
        for (int kt = 0; kt < n_tiles; ++kt, ++t) {
          if (t >= T::kStages)   // the slot's previous tile is consumed
            hop::bar_wait(empty(t), parity(t, T::kStages) ^ 1);
          const uint32_t ks = kv_s + (t % T::kStages) * T::kStageBytes;
          hop::bar_arrive_tx(full(t), T::kStageBytes);
          for (int sl = 0; sl < T::kSlabs; ++sl) {
            hop::tma_load(ks + sl * T::kKVSlab, &tk, full(t), 64 * sl, hk,
                          kt * kKeyTile, b);
            hop::tma_load(ks + T::kKVBytes + sl * T::kKVSlab, &tv, full(t),
                          64 * sl, hk, kt * kKeyTile, b);
          }
        }
        ++it;
      }
    }
  } else {
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const float scale = scale_log2 / kLog2e;
    auto k_tile = [&](int t) {
      return kv_s + (t % T::kStages) * T::kStageBytes;
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) hop::bar_arrive(bar);
    };
    float acc[D / 2], sc[kKeyTile / 2];
    uint32_t ap[kKeyTile / 16][4];
    int it = 0, t = 0;
    for (int r = 0; r < items.rounds(); ++r) {
      const int bh = items.head(r);
      if (bh >= items.n_bh) continue;
      const int b = bh / H, h = bh % H;
      const int qt = items.q_tile(r);
      const int n_tiles = (tile_end(qt) + kKeyTile - 1) / kKeyTile;
      const int r0 = qt * T::kBlockRows + wg * hop::kTileRows;
      // the thread's rows, and one past each one's last live key
      const int row[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
      const int end_r[2] = {live_end(row[0], Sk, q_off, k_off, causal),
                            live_end(row[1], Sk, q_off, k_off, causal)};
      // keys below all_end are live for every row of the warpgroup; its
      // tiles from n_live on hold no live key of any of its rows
      const int all_end =
          r0 < Sq ? live_end(r0, Sk, q_off, k_off, causal) : 0;
      const int any_end =
          r0 < Sq ? live_end(min(r0 + hop::kTileRows, Sq) - 1, Sk, q_off,
                             k_off, causal)
                  : 0;
      const int n_live = (any_end + kKeyTile - 1) / kKeyTile;
      const uint32_t qw = q_buf(it) + wg * T::kSlabs * hop::kSlabBytes;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      hop::bar_wait(q_full(it), parity(it, 2));

      for (int kt = 0; kt < n_tiles; ++kt) {
        const int tk = t + kt;
        hop::bar_wait(full(tk), parity(tk, T::kStages));
        if (kt < n_live) {   // warpgroup-uniform
          issue_s<D>(sc, qw, k_tile(tk));
          hop::wg_wait<0>();
          hop::pin(sc);
          softmax_at<kKeyTile>(kt * kKeyTile, all_end, end_r, t4, sc,
                               scale_log2, m, l, alpha);
          pack_p<kKeyTile>(sc, ap);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
          issue_pv<D>(acc, ap, k_tile(tk) + T::kKVBytes);
          hop::wg_wait<0>();
          hop::pin(acc);
        }
        release(empty(tk));
      }
      release(q_empty(it));
      t += n_tiles;
      ++it;

      // o = acc / l, lse = m * scale + ln(l) (natural-log units); a row
      // with no live key gets o = 0, lse = -1e30
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = row[i];
        if (qi >= Sq) continue;
        const int64_t rr = ((int64_t)b * Sq + qi) * H + h;
        const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
        bf16* out = o + rr * D + 2 * t4;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
              __floats2bfloat162_rn(acc[4 * n + 2 * i] * inv,
                                    acc[4 * n + 2 * i + 1] * inv);
        if (t4 == 0) lse[rr] = l[i] > 0.f ? m[i] * scale + logf(l[i]) : kNeg;
      }
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, int Sq, int Sk, int H, int Hkv, int q_off,
                 int k_off, int causal, float scale, cudaStream_t stream) {
  using T = FwdTiles<D>;
  CUtensorMap tq, tk, tv;
  int rc = hop::make_map(&tq, q, D, H, Sq, B, hop::kTileRows);
  if (rc == 0) rc = hop::make_map(&tk, k, D, Hkv, Sk, B, T::kKeyTile);
  if (rc == 0) rc = hop::make_map(&tv, v, D, Hkv, Sk, B, T::kKeyTile);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  // one block an SM at most: `group` heads at a time, one block for each
  // of their query tiles
  const int n_qt = (Sq + T::kBlockRows - 1) / T::kBlockRows;
  const int group = std::max(1, std::min(B * H, hop::sm_count() / n_qt));
  fwd_wgmma_kernel<D><<<(unsigned)group * n_qt, T::kThreads, T::kSmem,
                        stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), B, Sq, Sk,
      H, Hkv, q_off, k_off, causal, scale * kLog2e, group);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           void* ws, int B, int Sq, int Sk, int H, int Hkv, int D, int q_off,
           int k_off, int causal, float scale, cudaStream_t stream) {
  const int n_split = num_splits(Sq, Sk, q_off, k_off, causal);
  if (n_split > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (kBQ * D + 2 * kTileKeys * tile_ld(D));
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ, n_split);
  fwd_kernel<T, DMAX><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      static_cast<float*>(ws), Sq, Sk, H, Hkv, D, q_off, k_off, causal, scale);
  if (n_split > 1) {
    const int64_t rows = (int64_t)B * Sq * H;
    merge_kernel<T, DMAX><<<(unsigned)((rows + kWarps - 1) / kWarps),
                            kWarps * 32, 0, stream>>>(
        static_cast<const float*>(ws), static_cast<T*>(o),
        static_cast<float*>(lse), rows, n_split, Sq, Sk, H, D, q_off, k_off,
        causal);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(const void* q, const void* k, const void* v, void* o,
                 void* lse, void* ws, int B, int Sq, int Sk, int H, int Hkv,
                 int D, int q_off, int k_off, int causal, float scale,
                 cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, lse, ws, B, Sq, Sk, H, Hkv, D, q_off,
                         k_off, causal, scale, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, lse, ws, B, Sq, Sk, H, Hkv, D, q_off,
                          k_off, causal, scale, stream);
  return launch<T, 256>(q, k, v, o, lse, ws, B, Sq, Sk, H, Hkv, D, q_off,
                        k_off, causal, scale, stream);
}

}  // namespace

// Bytes of f32 workspace bps_flash_fwd needs for these sizes: 0 when the
// tensor-core path runs them (dtype 1 = bf16; aligned: q, k and v start on
// 16 bytes) or their live keys fit one split.
extern "C" long long bps_flash_fwd_workspace(int dtype, int aligned, int B,
                                             int Sq, int Sk, int H, int D,
                                             int q_off, int k_off,
                                             int causal) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (use_mma(dtype, aligned, B, Sq, H, D)) return 0;
  const int n_split = num_splits(Sq, Sk, q_off, k_off, causal);
  if (n_split == 1) return 0;
  return (long long)sizeof(float) * n_split * B * Sq * H * (D + 2);
}

// dtype: 0 = float32, 1 = bfloat16; scale = 1/sqrt(D) rounded to f32 by the
// caller, as the plain version rounds it. ws: bps_flash_fwd_workspace bytes
// of device memory (may be null when that is 0). Returns a cudaError_t
// (0 = success). The Python wrapper has checked shapes (D <= 256,
// H % Hkv == 0), dtypes, devices and contiguity.
extern "C" int bps_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, void* ws, int dtype, int B,
                             int Sq, int Sk, int H, int Hkv, int D, int q_off,
                             int k_off, int causal, float scale,
                             void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* const rows[3] = {q, k, v};
  if (use_mma(dtype, mma_rows_ok(rows, 3, D), B, Sq, H, D)) {
    if (D == 64)
      return launch_wgmma<64>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, q_off,
                              k_off, causal, scale, s);
    return launch_wgmma<128>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, q_off, k_off,
                             causal, scale, s);
  }
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(q, k, v, o, lse, ws, B, Sq, Sk, H, Hkv,
                                       D, q_off, k_off, causal, scale, s);
  return dispatch_dim<float>(q, k, v, o, lse, ws, B, Sq, Sk, H, Hkv, D, q_off,
                             k_off, causal, scale, s);
}
