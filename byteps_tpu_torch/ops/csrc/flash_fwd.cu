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
// Two paths. bf16 grids of at least kMmaMinBlocks 64-row tiles (training,
// long prefills) take the persistent wgmma kernel (fwd_wgmma_kernel): no
// splits, k and v streamed by TMA. Every other grid (the serving tier's
// chunks, f32, head dims other than 64 and 128) takes the split path
// (fwd_split_kernel, at the end of this file): the keys are cut into
// splits of kSplitKeys counted from key 0, the splits of one query tile
// run on the blocks of one thread-block cluster, and the partial states
// meet in shared memory, so a call is one launch with no workspace.
//
// What bounds them. At the prefill shapes of GPT-2 medium (D = 64, at
// most a few thousand keys) the work is 4 * D FLOPs per live (row, key)
// pair. At the training shape (B*H = 128, S = 1024) bytes and work
// balance: 67 MB of q, k, v and o (0.020 ms a layer at 3.35 TB/s) and 17
// GFLOP (0.017 ms at 989 TFLOP/s bf16). Only wgmma reaches that rate on
// Hopper, and only fed by tiles that arrive while the previous ones are
// multiplied: the path streams k and v by TMA through a ring that a
// producer warp keeps full, so no copy waits on the math or the math on
// a copy, and the blocks persist, so one item's start and end overlap the
// next one's copies. What it still pays: one exponential a live pair,
// and at D = 64 the MUFU unit's 16 a clock an SM take as long as the
// pair's 256 FLOPs on the tensor cores; and a warpgroup's softmax waits
// on its own products, overlapping only the other warpgroup's. A serving
// chunk (32 or 64 rows against at most 1024 keys, 16 heads) moves under a
// megabyte and does a few tens of MFLOP: a few microseconds of latency,
// not bytes or operations, bound it (see the split section).
#include <algorithm>
#include <atomic>
#include <cmath>

#include "attn_common.cuh"
#include "hopper.cuh"

namespace {

using namespace bps;

// one past the last key live for query row qi
__host__ __device__ __forceinline__ int live_end(int qi, int Sk, int q_off,
                                                 int k_off, int causal) {
  if (!causal) return Sk;
  const int e = q_off + qi - k_off + 1;
  return e < 0 ? 0 : (e < Sk ? e : Sk);
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

// ---------------------------------------------------------------------------
// Split path: every grid use_mma does not send to the wgmma kernel.
//
// A query tile of `rows` rows of one (b, h) is one thread-block cluster of
// `cluster` blocks. The keys are cut into splits of kSplitKeys counted from
// key 0; the tile's splits (those below its last row's live end) are
// dealt to the cluster's blocks in consecutive runs of `per`, so block c
// takes splits [c * per, (c + 1) * per). A block stages a split's k and v
// in shared memory and folds them into each row's online-softmax state
// (m, l, acc) from a fresh state; it then stores every row's partial state
// of that split, through distributed shared memory, into the slot of that
// (row, split) in the block that merges the row: the tile's blocks that
// hold a split (the first `active`) merge its rows, row r in block
// r % active. After one cluster barrier each of them folds its rows'
// slots in split order (running maximum, each state rescaled to it) and
// writes o and lse. A block with no split of its tile (under the causal
// mask, a prefill's early tiles hold fewer splits than its last) exits
// once the cluster has started. No workspace, no second kernel, no
// atomics; each output element has one writer. Where the tiles alone
// fill the card, a cluster is one block, which takes all of its tile's
// splits in turn (split_plan).
//
// Invariance. A row's o and lse depend only on its q row and its live
// keys: splits and the key tiles inside them start at fixed key indices,
// a row's state in a split is a function of its own keys there (a row that
// takes no key of a tile keeps its state; a key past its end counts as
// -inf, or with p = 0), the merge reads exactly the row's live splits, in
// split order, and a row with one live split ends with that split's state
// unscaled. So a row comes out bit for bit the same whatever the batch,
// the other rows of its chunk, Sk past its live keys, or the plan (rows a
// tile, cluster size, splits a block), which depends on the shapes only.
//
// Two bodies fold a split. bf16 at D = 64 or 128 with 16-byte aligned
// rows runs on the tensor cores: a block is one warpgroup, a tile 64
// query rows; q and the split's k and v are staged as bf16 by cp.async
// into the 128-byte swizzled slabs wgmma reads (hopper.cuh), v landing
// behind the first S product; s = q.k^T (SS) and o += p.v (RS, p from
// registers) are wgmma products over two 64-key tiles, with the wgmma
// path's softmax between them (base 2, masking only the tiles that
// cross a row's end), p rounded to bf16 for the PV product while l sums
// the unrounded p. A 32-row serving chunk leaves half the tile idle; on
// an H100 this form still took less time than one warp of mma.sync
// m16n8k16 per 16 rows, at 32 rows and at 64, at head dim 64 and 128.
// f32 and the other head dims take the FMA body: k and v widened to f32
// in shared memory in 32-key tiles, four rows a warp folded by fold_rows
// (attn_common.cuh).
//
// What bounds it. Serve's chunk (32 rows at position 256 against 512
// keys, 16 heads, bf16) moves 1.3 MB and does 36 MFLOP: 0.0004 ms of
// bytes at 3.35 TB/s. Its time is latency: the launch, one round trip
// for q, k and v, two dependent products and a softmax, one cluster
// barrier, the merge. The design keeps that chain short: one launch,
// every copy of a block issued at once, a split per block in a cluster
// of up to 8 (16 past 8 splits where 8 blocks' slots do not fit), the
// partials pushed (never pulled) into the merging blocks,
// which merge 4 rows a warp and write o in 16-byte vectors.
// ---------------------------------------------------------------------------
constexpr int kSplitKeys = 128;   // keys a split
constexpr int kSubKeys = 64;      // keys a tensor-core tile of a split
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kMaxClusterNonPortable = 16;
constexpr int kFmaRowsPerWarp = 4;
// Where a grid's 16-row tiles alone number this many (two an SM on an
// H100), one block takes all of a tile's splits: more blocks a tile buy
// no parallelism there, and many clusters schedule slowly (a 700-row f32
// prefill took twice the parent's time on clusters of 6, and less than
// it on one block a tile).
constexpr int kFillTiles = 264;
constexpr size_t kSplitSmemCap = 227 * 1024;   // a block's most

// The launch plan, a function of the shapes alone. A block is one
// warpgroup (the tensor-core body), or a warp for every four rows.
__host__ __device__ constexpr int split_threads(bool mma, int rows) {
  return mma ? 128 : rows / kFmaRowsPerWarp * 32;
}

struct SplitPlan {
  int rows;      // query rows a tile (a cluster)
  int n_qt;      // query tiles
  int n_split;   // splits of the longest tile
  int cluster;   // blocks a cluster
  int per;       // consecutive splits a block
  size_t body;   // bytes of staged q, k and v
  size_t smem;   // body, then the merge slots
};

// A tile of n_s splits is merged by its first ceil(n_s / per) blocks (by
// block 0 when it has none), each holding [rows it merges][n_s] slots of
// D + 2 f32 (m, l, acc); the bytes of the largest over n_s <= n_split.
size_t slot_bytes(int rows, int per, int n_split, int D) {
  size_t most = 0;
  for (int n_s = 1; n_s <= n_split; ++n_s) {
    const int mergers = (n_s + per - 1) / per;
    most = std::max(most, (size_t)((rows + mergers - 1) / mergers) * n_s);
  }
  return sizeof(float) * most * (D + 2);
}

// the tensor-core body: q, then k and v (two 64-key tiles each), each a
// stack of D / 64 slabs of 64 rows from a 1024-byte boundary; the FMA
// body: q, k and v widened to f32
size_t body_bytes(bool mma, int rows, int D) {
  const size_t b =
      mma ? hop::kAtom + (size_t)5 * (D / 64) * hop::kSlabBytes
          : sizeof(float) * ((size_t)rows * D + 2 * kTileKeys * tile_ld(D));
  return (b + 15) & ~(size_t)15;
}

// Tiles: 64 rows (the tensor-core body); in the FMA body 16, or 32 from
// 64 rows on where the tiles do not fill the card (half the clusters:
// multitenant's 64-row f32 chunk). Clusters: one block a tile where the
// tiles fill the card, else up to 8 blocks, or up to 16 where the merge
// slots of 8 do not fit; cudaErrorInvalidValue where those of 16 do not
// either (past about 9,000 keys at D = 128 in bf16, 20,000 at D = 64,
// 14,000 in the FMA body at D = 256).
int split_plan(bool mma, int B, int H, int Sq, int Sk, int D, int q_off,
               int k_off, int causal, SplitPlan* p) {
  const int kend = live_end(Sq - 1, Sk, q_off, k_off, causal);
  p->n_split = std::max(1, (kend + kSplitKeys - 1) / kSplitKeys);
  const bool fills =
      !mma && (long long)B * H * ((Sq + 15) / 16) >= kFillTiles;
  p->rows = mma ? hop::kTileRows : Sq >= 64 && !fills ? 32 : 16;
  p->n_qt = (Sq + p->rows - 1) / p->rows;
  p->body = body_bytes(mma, p->rows, D);
  for (const int most : {fills ? 1 : kMaxCluster, kMaxCluster,
                         kMaxClusterNonPortable}) {
    p->cluster = std::min(p->n_split, most);
    p->per = (p->n_split + p->cluster - 1) / p->cluster;
    p->smem = p->body + slot_bytes(p->rows, p->per, p->n_split, D);
    if (p->smem <= kSplitSmemCap) return 0;
  }
  return (int)cudaErrorInvalidValue;
}

// The tensor-core body, for one 64-key tile of a split at key k0: the
// warpgroup's S product of its 64 rows (q at shared address q_s) against
// the tile's keys (k_s), both 64-column slab stacks in the 128-byte
// swizzled layout, then the softmax; p comes back as the A fragments of
// the PV product, alpha as the rows' rescale factors (split_s). Then o +=
// p.v from the tile's values at v_s (split_pv). m is the raw row maximum
// (-inf before any key), l and acc as the wgmma path keeps them; the
// thread's rows are g and g + 8 of its warp's 16 (end_r: one past each
// one's last live key; every row of the tile sees the keys below all_end).
template <int D>
__device__ __forceinline__ void split_s(uint32_t q_s, uint32_t k_s, int k0,
                                        int all_end, const int (&end_r)[2],
                                        float scale_log2, float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        uint32_t (&ap)[kSubKeys / 16][4]) {
  float sc[kSubKeys / 2];
#pragma unroll
  for (int i = 0; i < kSubKeys / 2; ++i) sc[i] = 0.f;
  hop::pin(sc);
  hop::wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hop::mma_ss<kSubKeys>(sc, hop::desc_k(q_s, kk, hop::kSlabBytes),
                          hop::desc_k(k_s, kk, hop::kSlabBytes), kk > 0);
  hop::wg_commit();
  hop::wg_wait<0>();
  hop::pin(sc);
  softmax_at<kSubKeys>(k0, all_end, end_r, threadIdx.x & 3, sc, scale_log2,
                       m, l, alpha);
  pack_p<kSubKeys>(sc, ap);
}

template <int D>
__device__ __forceinline__ void split_pv(
    const uint32_t (&ap)[kSubKeys / 16][4], uint32_t v_s,
    float (&acc)[D / 2]) {
  hop::pin(acc);
  hop::wg_fence();
#pragma unroll
  for (int j = 0; j < kSubKeys / 16; ++j)
    hop::mma_rs<D>(acc, ap[j], hop::desc_mn(v_s, j, hop::kSlabBytes), 1);
  hop::wg_commit();
  hop::wg_wait<0>();
  hop::pin(acc);
}

// where TMA's 128-byte swizzle puts the 16-byte chunk c of row r of a
// 64-row slab (hopper.cuh)
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void st_cluster2(uint32_t a, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(a),
               "f"(x), "f"(y)
               : "memory");
}

// n (at most N) outputs of a row from f32, one 16-byte vector at a time
// where dst is aligned and n is whole vectors
template <typename T, int N>
__device__ __forceinline__ void store_out(T* dst, const float (&x)[N],
                                          int n) {
  constexpr int V = 16 / sizeof(T);
  if (n % V == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
    for (int e = 0; e < N; e += V) {
      if (e >= n) break;
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
      } else {
        uint4 u;
        u.x = pack_bf16(x[e], x[e + 1]);
        u.y = pack_bf16(x[e + 2], x[e + 3]);
        u.z = pack_bf16(x[e + 4], x[e + 5]);
        u.w = pack_bf16(x[e + 6], x[e + 7]);
        *reinterpret_cast<uint4*>(dst + e) = u;
      }
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < N; ++e)
    if (e < n) dst[e] = from_f32<T>(x[e]);
}

// Launched in clusters of gridDim.x / (B * H) blocks along x: block
// blockIdx.x % cluster of the cluster of (b, h) = blockIdx.x / cluster,
// and query tile gridDim.y - 1 - blockIdx.y (under the causal mask the
// last tiles hold the most splits: they start first). MMA: the
// tensor-core body (T = bf16, DMAX = D in {64, 128}, ROWS = 64); else the
// FMA body (ROWS 16 or 32).
template <typename T, int DMAX, bool MMA, int ROWS>
__global__ void __launch_bounds__(split_threads(MMA, ROWS))
fwd_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                 int D, int q_off, int k_off, int causal, float scale,
                 int cluster, int per, int body) {
  constexpr int rows = ROWS;
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  float* slots = reinterpret_cast<float*>(smem + body);
  const int rank = blockIdx.x % cluster;
  const int bh = blockIdx.x / cluster;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * rows;
  const int nq = min(rows, Sq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int st_ld = D + 2;

  // the blocks of the cluster store into each other's slots only once
  // all of them have started: the first barrier phase says so
  cluster_arrive_relaxed();
  const int tile_end = live_end(q0 + nq - 1, Sk, q_off, k_off, causal);
  const int n_s = (tile_end + kSplitKeys - 1) / kSplitKeys;
  const int s_lo = rank * per, s_hi = min(s_lo + per, n_s);
  // the blocks that hold a split merge the rows (block 0 where none does);
  // the others have nothing to do and nothing is stored into their shared
  // memory: they arrive on both barrier phases and leave
  const int active = max(1, (n_s + per - 1) / per);
  if (rank >= active) {
    cluster_wait();
    cluster_arrive();
    return;
  }

  const int64_t q_pos = (int64_t)H * D, kv_pos = (int64_t)Hkv * D;
  const T* qb = q + ((int64_t)b * Sq + q0) * q_pos + (int64_t)h * D;
  const T* kb = k + (int64_t)b * Sk * kv_pos + (int64_t)hk * D;
  const T* vb = v + (int64_t)b * Sk * kv_pos + (int64_t)hk * D;

  // store this block's state of split s for tile row rr into the slot of
  // (rr, s) in rr's merging block
  auto slot_of = [&](int rr, int s) {
    return map_cluster(slots + ((int64_t)(rr / active) * n_s + s) * st_ld,
                       rr % active);
  };

  if constexpr (MMA) {
    constexpr int D_ = DMAX, kSl = D_ / 64;
    constexpr uint32_t kSlab = hop::kSlabBytes;
    uint8_t* const qs =
        smem + ((hop::kAtom - (hop::saddr(smem) & (hop::kAtom - 1))) &
                (hop::kAtom - 1));           // [kSl][64 rows]
    uint8_t* const ks = qs + kSl * kSlab;     // [2 tiles][kSl][64 keys]
    uint8_t* const vs = ks + 2 * kSl * kSlab;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = warp * 16;                 // the warp's first tile row
    const int end_r[2] = {live_end(q0 + r0 + g, Sk, q_off, k_off, causal),
                          live_end(q0 + r0 + g + 8, Sk, q_off, k_off, causal)};
    const int all_end = live_end(q0, Sk, q_off, k_off, causal);
    const float scale_log2 = scale * kLog2e;
    constexpr int cpr = kSl * 8;              // 16-byte chunks a row
    if (s_lo < s_hi)   // the tile's q rows, zeros past Sq
      for (int c = threadIdx.x; c < hop::kTileRows * cpr; c += blockDim.x) {
        const int r = c / cpr, sl = c / 8 % kSl, cc = c % 8;
        cp_async16_zfill(qs + sl * kSlab + sw128(r, cc),
                         qb + (r < nq ? r : 0) * q_pos + sl * 64 + cc * 8,
                         r < nq);
      }
    for (int s = s_lo; s < s_hi; ++s) {
      const int k_lo = s * kSplitKeys;
      const int nk = min(kSplitKeys, tile_end - k_lo);
      // whole 64-key tiles: keys past nk land as zeros (p = 0 for them)
      const int n_rows = (nk + kSubKeys - 1) / kSubKeys * kSubKeys;
      __syncthreads();   // the previous split's tiles are consumed
      // two copy groups: (q and) k, then v, which lands behind the first
      // S product
      for (int kv = 0; kv < 2; ++kv) {
        const T* src = kv ? vb : kb;
        uint8_t* dst = kv ? vs : ks;
        for (int c = threadIdx.x; c < n_rows * cpr; c += blockDim.x) {
          const int r = c / cpr, sl = c / 8 % kSl, cc = c % 8;
          const int t = r / kSubKeys;   // the 64-key tile
          cp_async16_zfill(
              dst + (t * kSl + sl) * kSlab + sw128(r - t * kSubKeys, cc),
              src + (int64_t)(k_lo + (r < nk ? r : 0)) * kv_pos + sl * 64 +
                  cc * 8,
              r < nk);
        }
        cp_async_commit();
      }
      cp_async_wait<1>();
      hop::fence_async_smem();
      __syncthreads();
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
      float acc[D_ / 2];
#pragma unroll
      for (int i = 0; i < D_ / 2; ++i) acc[i] = 0.f;
      uint32_t ap[kSubKeys / 16][4];
      const uint32_t q_s = hop::saddr(qs), k_s = hop::saddr(ks),
                     v_s = hop::saddr(vs);
      split_s<D_>(q_s, k_s, k_lo, all_end, end_r, scale_log2, m, l, alpha,
                  ap);
      cp_async_wait<0>();
      hop::fence_async_smem();
      __syncthreads();   // v has landed
      split_pv<D_>(ap, v_s, acc);
      if (kSubKeys < nk) {   // the split's second 64-key tile
        split_s<D_>(q_s, k_s + kSl * kSlab, k_lo + kSubKeys, all_end, end_r,
                    scale_log2, m, l, alpha, ap);
#pragma unroll
        for (int i = 0; i < D_ / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        split_pv<D_>(ap, v_s + kSl * kSlab, acc);
      }
      if (s == s_lo) cluster_wait();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rr = r0 + g + 8 * i;
        if (rr >= nq || end_r[i] <= k_lo) continue;  // no key of s
        const uint32_t a = slot_of(rr, s);
#pragma unroll
        for (int n = 0; n < D_ / 8; ++n)
          st_cluster2(a + 4 * (2 + 8 * n + 2 * t4), acc[4 * n + 2 * i],
                      acc[4 * n + 2 * i + 1]);
        if (t4 == 0) st_cluster2(a, m[i] * scale, l[i]);
      }
    }
  } else {
    constexpr int kThreads = split_threads(false, ROWS);
    float* qs = reinterpret_cast<float*>(smem);   // [ROWS][D]
    const int ld = tile_ld(D);
    float* ks = qs + ROWS * D;                    // [kTileKeys][ld]
    float* vs = ks + kTileKeys * ld;              // [kTileKeys][ld]
    const float* const no_scale[2] = {nullptr, nullptr};
    if (s_lo < s_hi) {   // rows past Sq stay zero
      float* const dst[1] = {qs};
      const T* const src[1] = {qb};
      const float* const sc[1] = {nullptr};
      stage_rows<T, T, kThreads, 1>(dst, D, src, q_pos, sc, 0, nq, D,
                                    threadIdx.x);
      for (int idx = nq * D + threadIdx.x; idx < ROWS * D;
           idx += blockDim.x)
        qs[idx] = 0.f;
    }
    for (int s = s_lo; s < s_hi; ++s) {
      const int k_lo = s * kSplitKeys;
      const int kend = min(tile_end, k_lo + kSplitKeys);
      int row_end[kFmaRowsPerWarp];   // one past the row's last key of s
      float m[kFmaRowsPerWarp], l[kFmaRowsPerWarp];
      float acc[kFmaRowsPerWarp][DMAX / 32];
#pragma unroll
      for (int rr = 0; rr < kFmaRowsPerWarp; ++rr) {
        const int r = warp * kFmaRowsPerWarp + rr;
        row_end[rr] = r < nq ? min(live_end(q0 + r, Sk, q_off, k_off, causal),
                                   kend)
                             : 0;
        m[rr] = kNeg;
        l[rr] = 0.f;
#pragma unroll
        for (int i = 0; i < DMAX / 32; ++i) acc[rr][i] = 0.f;
      }
      for (int k0 = k_lo; k0 < kend; k0 += kTileKeys) {
        const int n = min(kTileKeys, kend - k0);
        __syncthreads();   // the previous tile is consumed (qs is written)
        float* const dst[2] = {ks, vs};
        const T* const src[2] = {kb + k0 * kv_pos, vb + k0 * kv_pos};
        stage_rows<T, T, kThreads, 2>(dst, ld, src, kv_pos, no_scale, 0, n,
                                      D, threadIdx.x);
        __syncthreads();
        int n_live[kFmaRowsPerWarp];
#pragma unroll
        for (int rr = 0; rr < kFmaRowsPerWarp; ++rr)
          n_live[rr] = min(n, row_end[rr] - k0);
        fold_rows<kFmaRowsPerWarp, DMAX>(qs + warp * kFmaRowsPerWarp * D, ks,
                                         vs, ld, D, n_live, scale, m, l, acc);
      }
      if (s == s_lo) cluster_wait();
#pragma unroll
      for (int rr = 0; rr < kFmaRowsPerWarp; ++rr) {
        const int r = warp * kFmaRowsPerWarp + rr;
        if (row_end[rr] <= k_lo) continue;   // past Sq, or no key of s
        const uint32_t a = slot_of(r, s);
#pragma unroll
        for (int i = 0; i < DMAX / 32; ++i) {
          const int d = lane + 32 * i;
          if (d < D) st_cluster(a + 4 * (2 + d), acc[rr][i]);
        }
        if (lane == 0) {
          st_cluster(a, m[rr]);
          st_cluster(a + 4, l[rr]);
        }
      }
    }
  }
  if (s_lo >= s_hi) cluster_wait();   // a block with no split of this tile
  cluster_arrive();                   // this block's slot stores are done
  cluster_wait();                     // and every other block's

  // merge: 8 lanes a row, so a warp takes 4 rows at once (warp w: local
  // rows 4w.., then 4 * nw further; tile row rr = li * active + rank),
  // lane j of a row the columns [j * e_n, (j + 1) * e_n)
  constexpr int kRowLanes = 8, kCols = DMAX / kRowLanes;
  const int e_n = (D + kRowLanes - 1) / kRowLanes;
  const int d0 = (lane % kRowLanes) * e_n;
  const int n_d = max(0, min(e_n, D - d0));   // the lane's columns
  const int mrows = (rows + active - 1) / active;
  for (int li = warp * 4 + lane / kRowLanes; li < mrows; li += nw * 4) {
    const int rr = li * active + rank;
    if (rr >= nq) break;
    const int qi = q0 + rr;
    const int live =
        (live_end(qi, Sk, q_off, k_off, causal) + kSplitKeys - 1) / kSplitKeys;
    float mx = -INFINITY, l = 0.f, acc[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[e] = 0.f;
    for (int s = 0; s < live; ++s) {
      const float* st = slots + ((int64_t)li * n_s + s) * st_ld;
      const float ms = st[0], ls = st[1];
      if (s == 0) {   // the first split's state, unscaled
        mx = ms;
        l = ls;
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          if (e < n_d) acc[e] = st[2 + d0 + e];
        continue;
      }
      const float mn = fmaxf(mx, ms);
      const float a_old = expf(mx - mn), a_new = expf(ms - mn);
      l = l * a_old + ls * a_new;
#pragma unroll
      for (int e = 0; e < kCols; ++e)
        if (e < n_d) acc[e] = acc[e] * a_old + st[2 + d0 + e] * a_new;
      mx = mn;
    }
    const int64_t row = ((int64_t)b * Sq + qi) * H + h;
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[e] *= inv;
    store_out<T, kCols>(o + row * D + d0, acc, n_d);
    if (lane % kRowLanes == 0) lse[row] = l > 0.f ? mx + logf(l) : kNeg;
  }
}

// Lift the kernel's dynamic shared memory limit to kSplitSmemCap and
// allow clusters of up to 16 blocks, once per instantiation and device.
template <typename T, int DMAX, bool MMA, int ROWS>
int split_attributes() {
  static std::atomic<unsigned> done{0};   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = 1u << (dev & 31);
  if (done.load() & bit) return 0;
  err = cudaFuncSetAttribute(fwd_split_kernel<T, DMAX, MMA, ROWS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSplitSmemCap);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fwd_split_kernel<T, DMAX, MMA, ROWS>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return (int)err;
  done.fetch_or(bit);
  return 0;
}

template <typename T, int DMAX, bool MMA, int ROWS>
int launch_split(const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
                 int q_off, int k_off, int causal, float scale,
                 const SplitPlan& p, cudaStream_t stream) {
  const int err = split_attributes<T, DMAX, MMA, ROWS>();
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.cluster * B * H, p.n_qt, 1);
  cfg.blockDim = dim3(split_threads(MMA, ROWS));
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, fwd_split_kernel<T, DMAX, MMA, ROWS>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), Sq, Sk, H, Hkv, D, q_off, k_off, causal, scale,
      p.cluster, p.per, (int)p.body);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, int ROWS>
int split_fma_rows(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
                   int q_off, int k_off, int causal, float scale,
                   const SplitPlan& p, cudaStream_t s) {
  if (D <= 64)
    return launch_split<T, 64, false, ROWS>(q, k, v, o, lse, B, Sq, Sk, H,
                                            Hkv, D, q_off, k_off, causal,
                                            scale, p, s);
  if (D <= 128)
    return launch_split<T, 128, false, ROWS>(q, k, v, o, lse, B, Sq, Sk, H,
                                             Hkv, D, q_off, k_off, causal,
                                             scale, p, s);
  return launch_split<T, 256, false, ROWS>(q, k, v, o, lse, B, Sq, Sk, H, Hkv,
                                           D, q_off, k_off, causal, scale, p,
                                           s);
}

template <typename T>
int split_fma(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int Sq, int Sk, int H, int Hkv, int D, int q_off,
              int k_off, int causal, float scale, const SplitPlan& p,
              cudaStream_t s) {
  if (p.rows == 32)
    return split_fma_rows<T, 32>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, q_off,
                                 k_off, causal, scale, p, s);
  return split_fma_rows<T, 16>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, q_off,
                               k_off, causal, scale, p, s);
}

}  // namespace

// The route bps_flash_fwd takes for these inputs: 1 = the wgmma kernel,
// 0 = the split path (dtype 1 = bf16; q, k, v as bps_flash_fwd takes them).
extern "C" int bps_flash_fwd_route(const void* q, const void* k,
                                   const void* v, int dtype, int B, int Sq,
                                   int H, int D) {
  const void* const rows[3] = {q, k, v};
  return use_mma(dtype, mma_rows_ok(rows, 3, D), B, Sq, H, D) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16; scale = 1/sqrt(D) rounded to f32 by the
// caller, as the plain version rounds it. ws is not read (the split path
// merges in shared memory; it may be null). Returns a cudaError_t (0 =
// success). The Python wrapper has checked shapes (D <= 256,
// H % Hkv == 0), dtypes, devices and contiguity.
extern "C" int bps_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, void* ws, int dtype, int B,
                             int Sq, int Sk, int H, int Hkv, int D, int q_off,
                             int k_off, int causal, float scale,
                             void* stream) {
  (void)ws;
  if (B == 0 || Sq == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* const rows[3] = {q, k, v};
  const bool tc_rows = mma_rows_ok(rows, 3, D);
  if (use_mma(dtype, tc_rows, B, Sq, H, D)) {
    if (D == 64)
      return launch_wgmma<64>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, q_off,
                              k_off, causal, scale, s);
    return launch_wgmma<128>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, q_off, k_off,
                             causal, scale, s);
  }
  const bool mma = dtype == 1 && tc_rows;
  SplitPlan p;
  const int err = split_plan(mma, B, H, Sq, Sk, D, q_off, k_off, causal, &p);
  if (err != 0) return err;
  if (mma) {
    if (D == 64)
      return launch_split<bf16, 64, true, 64>(q, k, v, o, lse, B, Sq, Sk, H,
                                              Hkv, D, q_off, k_off, causal,
                                              scale, p, s);
    return launch_split<bf16, 128, true, 64>(q, k, v, o, lse, B, Sq, Sk, H,
                                             Hkv, D, q_off, k_off, causal,
                                             scale, p, s);
  }
  if (dtype == 1)
    return split_fma<bf16>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, q_off, k_off,
                           causal, scale, p, s);
  return split_fma<float>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, q_off, k_off,
                          causal, scale, p, s);
}
