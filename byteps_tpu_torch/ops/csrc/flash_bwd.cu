// Flash-attention backward for Hopper (sm_90a), f32 and bf16: two kernels.
//
// Replaces byteps_tpu/ops/flash_attention.py:_dq_kernel and :_dkv_kernel
// (launched by _bwd). With s = (q.k) * scale, p = exp(s - lse) on live
// (row, key) pairs and 0 elsewhere, dp = do.v and
// ds = p * ((dp - delta) + dlse):
//
//   dq = scale * sum_keys ds * k          (dq_kernel)
//   dk = scale * sum_rows ds * q          (dkv_kernel, summed over the
//   dv =         sum_rows p  * do          GQA group inside the block)
//
// delta = rowsum(do * o) in f32 comes from the caller, as the reference
// computes it in XLA outside Pallas. dlse may be null (a zero cotangent).
//
// Layouts (all contiguous): q, do, dq (B, Sq, H, D); k, v, dk, dv
// (B, Sk, Hkv, D); lse, delta, dlse (B, Sq, H) f32. Query row i sits at
// global position q_off + i, key j at k_off + j; with causal set, the pair
// is live iff q_off + i >= k_off + j. A row with no live key (lse = -1e30)
// gets dq = 0 and adds nothing to dk, dv: its p is 0, never exp(0) = 1.
//
// Rounding (the reference's, kept so the plain version can repeat it):
// products read the inputs widened to f32 and accumulate in f32; ds is
// rounded to the input dtype before the dq and dk products, and p before
// the dv product; outputs are written in the input dtype.
//
// Two paths, one pair of entry points. bf16 at D = 64 or 128 runs on the
// tensor cores (dq_wgmma_kernel, dkv_wgmma_kernel, below); f32 and every
// other head dim run on the CUDA cores in f32 FMAs (dq_kernel,
// dkv_kernel), whose sums follow the plain version's order.
//
// Design, both paths. In the dq kernel a block owns a tile of query
// rows and walks the causally live key tiles in order, staging k and v in
// shared memory; it forms s, p, dp and ds for its rows and accumulates dq
// in registers. The dk/dv kernel is the transpose: a block owns a tile of
// keys of one kv head and walks, for each of the G query heads of its
// group, the query tiles from the first row that sees its keys; the dk/dv
// accumulators stay in registers across the whole group, so GQA outputs
// come out narrow with no reduction pass. No atomics: each output element
// has one writer, and every sum runs in a fixed order, so the kernels are
// deterministic. The FMA path puts R rows (keys) on a warp and one key
// (row) of a 32-wide tile on each lane, so the R dot products share each
// load; the tensor-core paths put 64 rows (dq) or 64 keys (dk/dv) on a
// warpgroup.
//
// What bounds it. At GPT-2 medium's training shape (B*H = 128, S = 1024,
// D = 64, causal) the work is 6*D (dq) and 8*D (dkv) FLOPs per live
// (row, key) pair, about 25 and 34 GFLOP a layer, against a few tens of
// MB of inputs and outputs: operations bound, at 989 TFLOP/s bf16 on the
// tensor cores and 67 TFLOP/s f32 on the CUDA cores of an H100 SXM. Only
// wgmma reaches the tensor cores' full rate on Hopper, and only if the
// tiles arrive while the previous ones are multiplied: both kernels
// stream their tiles by TMA (dq the keys, dk/dv the query rows) through
// a ring of stages that a producer warp keeps full, and run their
// products as wgmma (dq three a tile, dk/dv four). What they still pay:
// the exponentials of p (one MUFU op a live pair, at a sixteenth of the
// tensor cores' rate for D = 64), and each consumer warpgroup waits on
// its own products, overlapping only with the other warpgroup's (at
// D = 128, where one consumer warpgroup runs, with nothing).
#include <algorithm>
#include <climits>
#include <cmath>

#include "attn_common.cuh"
#include "hopper.cuh"

namespace {

using namespace bps;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// rows (dq) or keys (dkv) each warp owns: fewer at wide heads, where the
// R x D/32 accumulators would spill
template <int DMAX> struct Own { static constexpr int R = DMAX <= 128 ? 8 : 4; };

__host__ __device__ __forceinline__ int round4(int D) { return (D + 3) & ~3; }

// Row stride of a tile read one row per lane with 16-byte loads: a
// quarter-warp's eight lanes then hit eight different 16-byte bank groups.
__host__ __device__ __forceinline__ int lane_ld(int D4) {
  return (D4 / 4) % 2 == 0 ? D4 + 4 : D4;
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// one past the last key live for query row qi
__host__ __device__ __forceinline__ int live_end(int qi, int Sk, int q_off,
                                                 int k_off, int causal) {
  if (!causal) return Sk;
  const int e = q_off + qi - k_off + 1;
  return e < 0 ? 0 : (e < Sk ? e : Sk);
}

// sa[r] = own_a[r] . lane_a, sb[r] = own_b[r] . lane_b over D4 columns
// (zero-padded past D). own rows are read by every lane of the warp
// (broadcast), the lane rows one per lane.
template <int R>
__device__ __forceinline__ void dots(const float* __restrict__ own_a,
                                     const float* __restrict__ own_b,
                                     const float* __restrict__ lane_a,
                                     const float* __restrict__ lane_b, int D4,
                                     float (&sa)[R], float (&sb)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) sa[r] = sb[r] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D4; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(lane_a + d);
    const float4 b = *reinterpret_cast<const float4*>(lane_b + d);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(own_a + r * D4 + d);
      const float4 y = *reinterpret_cast<const float4*>(own_b + r * D4 + d);
      sa[r] = fmaf(x.x, a.x, sa[r]);
      sa[r] = fmaf(x.y, a.y, sa[r]);
      sa[r] = fmaf(x.z, a.z, sa[r]);
      sa[r] = fmaf(x.w, a.w, sa[r]);
      sb[r] = fmaf(y.x, b.x, sb[r]);
      sb[r] = fmaf(y.y, b.y, sb[r]);
      sb[r] = fmaf(y.z, b.z, sb[r]);
      sb[r] = fmaf(y.w, b.w, sb[r]);
    }
  }
}

// The R weights a lane wrote at w + j * R, read back by every lane.
template <int R>
__device__ __forceinline__ void read_weights(const float* __restrict__ w,
                                             float (&out)[R]) {
#pragma unroll
  for (int r = 0; r < R; r += 4) {
    const float4 x = *reinterpret_cast<const float4*>(w + r);
    out[r] = x.x;
    out[r + 1] = x.y;
    out[r + 2] = x.z;
    out[r + 3] = x.w;
  }
}

template <int DMAX>
__host__ __device__ size_t dq_smem_floats(int D) {
  constexpr int R = Own<DMAX>::R;
  const int D4 = round4(D), ld = lane_ld(D4);
  return (size_t)2 * kWarps * R * D4 + 2 * kTileKeys * ld +
         kWarps * kTileKeys * R;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const float* __restrict__ dlse, T* __restrict__ dq, int Sq, int Sk,
          int H, int Hkv, int D, int q_off, int k_off, int causal,
          float scale) {
  constexpr int R = Own<DMAX>::R;
  constexpr int kRows = kWarps * R;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D4 = round4(D), ld = lane_ld(D4);
  float* qs = smem;                        // [kRows][D4]
  float* dos = qs + kRows * D4;            // [kRows][D4]
  float* ks = dos + kRows * D4;            // [kTileKeys][ld]
  float* vs = ks + kTileKeys * ld;         // [kTileKeys][ld]
  float* wbuf = vs + kTileKeys * ld;       // [kWarps][kTileKeys][R]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // zero padding columns and rows past the edges stay zero
  const int total = (int)dq_smem_floats<DMAX>(D);
  for (int i = threadIdx.x; i < total; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  const int64_t q_pos = (int64_t)H * D;
  const int64_t kv_pos = (int64_t)Hkv * D;
  const T* qb = q + (int64_t)b * Sq * q_pos + (int64_t)h * D;
  const T* dob = dout + (int64_t)b * Sq * q_pos + (int64_t)h * D;
  const T* kb = k + (int64_t)b * Sk * kv_pos + (int64_t)hk * D;
  const T* vb = v + (int64_t)b * Sk * kv_pos + (int64_t)hk * D;
  const float* const no_scale[2] = {nullptr, nullptr};
  {
    const int nq = min(kRows, Sq - q0);
    float* const dst[2] = {qs, dos};
    const T* const src[2] = {qb + (int64_t)q0 * q_pos, dob + (int64_t)q0 * q_pos};
    stage_rows<T, T, kThreads, 2>(dst, D4, src, q_pos, no_scale, 0, nq, D,
                                  threadIdx.x);
  }

  int row_end[R];
  float lse_r[R], delta_r[R], dlse_r[R], acc[R][DMAX / 32];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + warp * R + r;
    row_end[r] = 0;
    lse_r[r] = delta_r[r] = dlse_r[r] = 0.f;
    if (qi < Sq) {
      const int64_t row = ((int64_t)b * Sq + qi) * H + h;
      row_end[r] = live_end(qi, Sk, q_off, k_off, causal);
      lse_r[r] = lse[row];
      delta_r[r] = delta[row];
      dlse_r[r] = dlse != nullptr ? dlse[row] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < DMAX / 32; ++i) acc[r][i] = 0.f;
  }
  const int kend = live_end(min(q0 + kRows, Sq) - 1, Sk, q_off, k_off, causal);
  float* wl = wbuf + warp * kTileKeys * R;
  const float* own_q = qs + warp * R * D4;
  const float* own_do = dos + warp * R * D4;

  for (int k0 = 0; k0 < kend; k0 += kTileKeys) {
    const int n = min(kTileKeys, kend - k0);
    __syncthreads();  // the previous tile is consumed (and qs/dos written)
    {
      float* const dst[2] = {ks, vs};
      const T* const src[2] = {kb + k0 * kv_pos, vb + k0 * kv_pos};
      stage_rows<T, T, kThreads, 2>(dst, ld, src, kv_pos, no_scale, 0, n, D,
                                    threadIdx.x);
    }
    __syncthreads();
    int n_live[R], n_max = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      n_live[r] = min(n, row_end[r] - k0);
      n_max = max(n_max, n_live[r]);
    }
    if (n_max <= 0) continue;  // warp-uniform
    float s[R], dp[R];
    dots<R>(own_q, own_do, ks + lane * ld, vs + lane * ld, D4, s, dp);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p = lane < n_live[r] ? expf(s[r] * scale - lse_r[r]) : 0.f;
      wl[lane * R + r] = round_to<T>(p * ((dp[r] - delta_r[r]) + dlse_r[r]));
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < n_max; ++j) {
      float w[R];
      read_weights<R>(wl + j * R, w);
      const float* kr = ks + j * ld;
#pragma unroll
      for (int i = 0; i < DMAX / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          const float kd = kr[d];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][i] = fmaf(w[r], kd, acc[r][i]);
        }
      }
    }
    __syncwarp();  // wl is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + warp * R + r;
    if (qi >= Sq) continue;
    T* out = dq + (((int64_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DMAX / 32; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out[d] = from_f32<T>(acc[r][i] * scale);
    }
  }
}

template <int DMAX>
__host__ __device__ size_t dkv_smem_floats(int D) {
  constexpr int R = Own<DMAX>::R;
  const int D4 = round4(D), ld = lane_ld(D4);
  return (size_t)2 * kWarps * R * D4 + 2 * kTileKeys * ld +
         2 * kWarps * kTileKeys * R;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const float* __restrict__ dlse, T* __restrict__ dk,
           T* __restrict__ dv, int Sq, int Sk, int H, int Hkv, int D,
           int q_off, int k_off, int causal, float scale) {
  constexpr int R = Own<DMAX>::R;
  constexpr int kKeys = kWarps * R;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D4 = round4(D), ld = lane_ld(D4);
  float* ks = smem;                        // [kKeys][D4]
  float* vs = ks + kKeys * D4;             // [kKeys][D4]
  float* qs = vs + kKeys * D4;             // [kTileKeys][ld]  query rows
  float* dos = qs + kTileKeys * ld;        // [kTileKeys][ld]
  float* pbuf = dos + kTileKeys * ld;      // [kWarps][kTileKeys][R]
  float* dbuf = pbuf + kWarps * kTileKeys * R;

  const int bhk = blockIdx.x;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int G = H / Hkv;
  const int kb0 = blockIdx.y * kKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int total = (int)dkv_smem_floats<DMAX>(D);
  for (int i = threadIdx.x; i < total; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  const int64_t q_pos = (int64_t)H * D;
  const int64_t kv_pos = (int64_t)Hkv * D;
  const float* const no_scale[2] = {nullptr, nullptr};
  {
    const int nk = min(kKeys, Sk - kb0);
    float* const dst[2] = {ks, vs};
    const int64_t at = ((int64_t)b * Sk + kb0) * kv_pos + (int64_t)hk * D;
    const T* const src[2] = {k + at, v + at};
    stage_rows<T, T, kThreads, 2>(dst, D4, src, kv_pos, no_scale, 0, nk, D,
                                  threadIdx.x);
  }

  const int key0 = kb0 + warp * R;  // the warp's first key
  float dk_acc[R][DMAX / 32], dv_acc[R][DMAX / 32];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < DMAX / 32; ++i) dk_acc[r][i] = dv_acc[r][i] = 0.f;
  // the first query row that sees a key of the block, and of the warp
  const int i_blk = causal ? max(0, k_off + kb0 - q_off) : 0;
  const int i_warp = causal ? max(0, k_off + key0 - q_off) : 0;
  const int qt0 = (i_blk / kTileKeys) * kTileKeys;
  float* pl = pbuf + warp * kTileKeys * R;
  float* dl = dbuf + warp * kTileKeys * R;
  const float* own_k = ks + warp * R * D4;
  const float* own_v = vs + warp * R * D4;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* qb = q + (int64_t)b * Sq * q_pos + (int64_t)h * D;
    const T* dob = dout + (int64_t)b * Sq * q_pos + (int64_t)h * D;
    for (int q0 = qt0; q0 < Sq; q0 += kTileKeys) {
      const int n = min(kTileKeys, Sq - q0);
      __syncthreads();  // the previous tile is consumed (and ks/vs written)
      {
        float* const dst[2] = {qs, dos};
        const T* const src[2] = {qb + (int64_t)q0 * q_pos,
                                 dob + (int64_t)q0 * q_pos};
        stage_rows<T, T, kThreads, 2>(dst, ld, src, q_pos, no_scale, 0, n, D,
                                      threadIdx.x);
      }
      __syncthreads();
      const int i_start = min(n, max(0, i_warp - q0));  // warp-uniform
      if (i_start >= n || key0 >= Sk) continue;
      const int qi = q0 + lane;
      float lse_i = 0.f, delta_i = 0.f, dlse_i = 0.f;
      if (lane < n) {
        const int64_t row = ((int64_t)b * Sq + qi) * H + h;
        lse_i = lse[row];
        delta_i = delta[row];
        dlse_i = dlse != nullptr ? dlse[row] : 0.f;
      }
      float s[R], dp[R];
      dots<R>(own_k, own_v, qs + lane * ld, dos + lane * ld, D4, s, dp);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int key = key0 + r;
        const bool live = lane < n && key < Sk &&
                          (!causal || q_off + qi >= k_off + key);
        const float p = live ? expf(s[r] * scale - lse_i) : 0.f;
        pl[lane * R + r] = round_to<T>(p);
        dl[lane * R + r] = round_to<T>(p * ((dp[r] - delta_i) + dlse_i));
      }
      __syncwarp();
#pragma unroll 4
      for (int i = i_start; i < n; ++i) {
        float pw[R], dw[R];
        read_weights<R>(pl + i * R, pw);
        read_weights<R>(dl + i * R, dw);
        const float* qr = qs + i * ld;
        const float* dor = dos + i * ld;
#pragma unroll
        for (int c = 0; c < DMAX / 32; ++c) {
          const int d = lane + 32 * c;
          if (d < D) {
            const float qd = qr[d], dod = dor[d];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              dv_acc[r][c] = fmaf(pw[r], dod, dv_acc[r][c]);
              dk_acc[r][c] = fmaf(dw[r], qd, dk_acc[r][c]);
            }
          }
        }
      }
      __syncwarp();  // pl/dl are rewritten by the next tile
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int key = key0 + r;
    if (key >= Sk) continue;
    const int64_t at = (((int64_t)b * Sk + key) * Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < DMAX / 32; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dk[at + d] = from_f32<T>(dk_acc[r][c] * scale);
        dv[at + d] = from_f32<T>(dv_acc[r][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16 inputs, D = 64 or 128.
//
// The same two kernels with the products on the tensor cores as wgmma,
// fed by TMA through a ring of shared stages (hopper.cuh). dq is query-
// stationary and key-streaming, the forward's shape: persistent blocks
// walk (head, query tile) items and stream the keys past them. dk/dv is
// key-stationary and streams the query rows. ds is formed in the
// accumulator layout, rounded to bf16 (the rounding above) and fed to
// the next product as its register A operand. Sums over keys (dq) and
// rows (dk, dv) run in the tensor cores' order, so the two paths agree
// to rounding, not bit for bit.
// ---------------------------------------------------------------------------
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWide = 1 << 30;   // a column bound no tile reaches

// The dq kernel on the tensor cores (bf16, D = 64 or 128).
//
// A block is persistent, one an SM, taking hopper.cuh's Items: a head's
// query tile of 64 rows per consumer warpgroup, heads in groups of about
// one wave (their k and v stay in L2), query tiles snaked across rounds
// so every block carries the same causal work. One producer thread
// copies an item's q and do rows into one of two buffers and streams the
// k and v tiles of the item's live keys through a ring of four stages by
// TMA, each buffer and stage with a "full" mbarrier (its bytes landed)
// and an "empty" one (every consumer warp is done with it); it runs
// ahead across items. A consumer warpgroup loads its rows' lse, delta
// and dlse once an item, then a tile at a time forms s = q.k^T and dp =
// do.v^T as wgmma from shared memory, p = 2^(s * scale_log2 - lse *
// log2(e)) (one FFMA and one MUFU op a pair) and ds = p * ((dp - delta) +
// dlse) in the accumulator layout, rounds ds to bf16 and runs dq += ds.k
// with ds the register A operand and k read MN-major from the same
// stage. The mask is evaluated only on tiles that cross a row's causal
// end or the ragged edge of Sk. A row with no live key (lse = -1e30),
// and a row past Sq (zeros from TMA, never stored), takes lse = +inf,
// so its p is 2^-inf = 0 on every tile, masked or not. dq * scale is
// written once in bf16: one writer per element, no atomics, the keys
// summed in order.
template <int D> struct DqTiles {
  static constexpr int kSlabs = D / 64;
  // consumer warpgroups of 64 query rows, then one producer warp. A
  // thread holds s and dp (32 each), ds (16) and dq (D / 2); at D = 128
  // two consumers' 168-register budget would not hold that, one has 255
  static constexpr int kConsumers = D == 64 ? 2 : 1;
  static constexpr int kBlockRows = kConsumers * hop::kTileRows;
  static constexpr int kThreads = kConsumers * 128 + 32;
  static constexpr int kKeyTile = 64;   // keys a stage
  // an item's q rows: [warpgroup][slab][64 rows][128 B]; do the same
  // after them; two such buffers, so the next item's rows land while
  // this one's are in use
  static constexpr uint32_t kQBytes = kConsumers * kSlabs * hop::kSlabBytes;
  static constexpr uint32_t kItemBytes = 2 * kQBytes;
  // one k (or v) tile: [slab][kKeyTile keys][128 B]; a stage holds k, v
  static constexpr uint32_t kKVSlab = kKeyTile * 128;
  static constexpr uint32_t kKVBytes = kSlabs * kKVSlab;
  static constexpr uint32_t kStageBytes = 2 * kKVBytes;
  static constexpr int kStages = 4;
  static constexpr uint32_t kKVOff = 2 * kItemBytes;
  static constexpr uint32_t kBars = kKVOff + kStages * kStageBytes;
  // the barriers (q full and empty per buffer, then full and empty per
  // stage) and the slack that lets the tiles start on 1024 bytes
  static constexpr size_t kSmem = kBars + 8 * (4 + 2 * kStages) + hop::kAtom;
  static_assert(kSmem <= 227 * 1024, "one block an SM");
};

// ds of one key tile in the accumulator layout (rows: the thread's two
// query rows r; columns: keys 8n + 2 t4 and + 1), rounded to bf16 as the
// A fragments of dq += ds.k: keys 16j.. of the tile in ads[j]. lse2 is
// the rows' lse in base 2 (+inf for a row whose p is 0 throughout), dl
// and dz their delta and dlse. MASKED tiles zero the keys at or past
// lim[r] of the thread's columns.
template <int KT, bool MASKED>
__device__ __forceinline__ void ds_tile(const float (&sc)[KT / 2],
                                        const float (&dp)[KT / 2],
                                        const int (&lim)[2],
                                        const float (&lse2)[2],
                                        const float (&dl)[2],
                                        const float (&dz)[2],
                                        float scale_log2,
                                        uint32_t (&ads)[KT / 16][4]) {
#pragma unroll
  for (int n = 0; n < KT / 8; ++n) {
    float d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = hop::ex2(fmaf(sc[4 * n + e], scale_log2, -lse2[r]));
      if (MASKED && n * 8 + (e & 1) >= lim[r]) p = 0.f;
      d[e] = p * ((dp[4 * n + e] - dl[r]) + dz[r]);
    }
    ads[n >> 1][(n & 1) * 2] = pack_bf16(d[0], d[1]);
    ads[n >> 1][(n & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
  }
}

template <int D>
__global__ void __launch_bounds__(DqTiles<D>::kThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const float* __restrict__ dlse, bf16* __restrict__ dq,
                int B, int Sq, int Sk, int H, int Hkv, int q_off, int k_off,
                int causal, float scale, float scale_log2, int group) {
  using T = DqTiles<D>;
  constexpr int KT = T::kKeyTile, kConsumers = T::kConsumers;
  extern __shared__ uint8_t smem_tc[];
  const uint32_t base =
      (hop::saddr(smem_tc) + hop::kAtom - 1) & ~(hop::kAtom - 1);
  const uint32_t kv_s = base + T::kKVOff, bars = base + T::kBars;
  auto q_buf = [&](int it) { return base + (it & 1) * T::kItemBytes; };
  auto q_full = [&](int it) { return bars + 8 * (it & 1); };
  auto q_empty = [&](int it) { return bars + 8 * (2 + (it & 1)); };
  auto full = [&](int t) { return bars + 8 * (4 + t % T::kStages); };
  auto empty = [&](int t) {
    return bars + 8 * (4 + T::kStages + t % T::kStages);
  };
  auto k_tile = [&](int t) {
    return kv_s + (t % T::kStages) * T::kStageBytes;
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
    // consumers by the ring (and by a row buffer across items)
    if (threadIdx.x == kConsumers * 128) {
      int it = 0, t = 0;
      for (int r = 0; r < items.rounds(); ++r) {
        const int bh = items.head(r);
        if (bh >= items.n_bh) continue;
        const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
        const int qt = items.q_tile(r), q0 = qt * T::kBlockRows;
        if (it >= 2) hop::bar_wait(q_empty(it), parity(it, 2) ^ 1);
        hop::bar_arrive_tx(q_full(it), T::kItemBytes);
        for (int w = 0; w < kConsumers; ++w)
          for (int sl = 0; sl < T::kSlabs; ++sl) {
            const uint32_t at =
                q_buf(it) + (w * T::kSlabs + sl) * hop::kSlabBytes;
            hop::tma_load(at, &tq, q_full(it), 64 * sl, h,
                          q0 + hop::kTileRows * w, b);
            hop::tma_load(at + T::kQBytes, &tdo, q_full(it), 64 * sl, h,
                          q0 + hop::kTileRows * w, b);
          }
        const int n_tiles = (tile_end(qt) + KT - 1) / KT;
        for (int kt = 0; kt < n_tiles; ++kt, ++t) {
          if (t >= T::kStages)   // the slot's previous tile is consumed
            hop::bar_wait(empty(t), parity(t, T::kStages) ^ 1);
          hop::bar_arrive_tx(full(t), T::kStageBytes);
          for (int sl = 0; sl < T::kSlabs; ++sl) {
            hop::tma_load(k_tile(t) + sl * T::kKVSlab, &tk, full(t), 64 * sl,
                          hk, kt * KT, b);
            hop::tma_load(k_tile(t) + T::kKVBytes + sl * T::kKVSlab, &tv,
                          full(t), 64 * sl, hk, kt * KT, b);
          }
        }
        ++it;
      }
    }
  } else {
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) hop::bar_arrive(bar);
    };
    float acc[D / 2], sc[KT / 2], dp[KT / 2];
    uint32_t ads[KT / 16][4];
    int it = 0, t = 0;
    for (int r = 0; r < items.rounds(); ++r) {
      const int bh = items.head(r);
      if (bh >= items.n_bh) continue;
      const int b = bh / H, h = bh % H;
      const int qt = items.q_tile(r);
      const int n_tiles = (tile_end(qt) + KT - 1) / KT;
      const int r0 = qt * T::kBlockRows + wg * hop::kTileRows;
      // the thread's rows, one past each one's last live key, and their
      // lse (base 2), delta and dlse, read once for the item
      const int row[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
      int end_r[2];
      float lse2[2], dl[2], dz[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        end_r[i] = row[i] < Sq ? live_end(row[i], Sk, q_off, k_off, causal)
                               : 0;
        lse2[i] = INFINITY;
        dl[i] = dz[i] = 0.f;
        if (end_r[i] > 0) {
          const int64_t rr = ((int64_t)b * Sq + row[i]) * H + h;
          lse2[i] = lse[rr] * kLog2e;
          dl[i] = delta[rr];
          dz[i] = dlse != nullptr ? dlse[rr] : 0.f;
        }
      }
      // keys below all_end are live for every row of the warpgroup; its
      // tiles from n_live on hold no live key of any of its rows
      const int all_end =
          r0 < Sq ? live_end(r0, Sk, q_off, k_off, causal) : 0;
      const int any_end =
          r0 < Sq ? live_end(min(r0 + hop::kTileRows, Sq) - 1, Sk, q_off,
                             k_off, causal)
                  : 0;
      const int n_live = (any_end + KT - 1) / KT;
      const uint32_t qw = q_buf(it) + wg * T::kSlabs * hop::kSlabBytes;
      const uint32_t dow = qw + T::kQBytes;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      hop::bar_wait(q_full(it), parity(it, 2));

      for (int kt = 0; kt < n_tiles; ++kt) {
        const int ti = t + kt;
        hop::bar_wait(full(ti), parity(ti, T::kStages));
        if (kt < n_live) {   // warpgroup-uniform
          const uint32_t ks = k_tile(ti), vs = ks + T::kKVBytes;
#pragma unroll
          for (int i = 0; i < KT / 2; ++i) sc[i] = dp[i] = 0.f;
          hop::pin(sc);
          hop::pin(dp);
          hop::wg_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            hop::mma_ss<KT>(sc, hop::desc_k(qw, kk, hop::kSlabBytes),
                            hop::desc_k(ks, kk, T::kKVSlab), kk > 0);
            hop::mma_ss<KT>(dp, hop::desc_k(dow, kk, hop::kSlabBytes),
                            hop::desc_k(vs, kk, T::kKVSlab), kk > 0);
          }
          hop::wg_commit();
          hop::wg_wait<0>();
          hop::pin(sc);
          hop::pin(dp);
          const int k0 = kt * KT;
          const int lim[2] = {end_r[0] - k0 - 2 * t4, end_r[1] - k0 - 2 * t4};
          if (k0 + KT > all_end)
            ds_tile<KT, true>(sc, dp, lim, lse2, dl, dz, scale_log2, ads);
          else
            ds_tile<KT, false>(sc, dp, lim, lse2, dl, dz, scale_log2, ads);
          hop::pin(acc);
          hop::wg_fence();
#pragma unroll
          for (int j = 0; j < KT / 16; ++j)
            hop::mma_rs<D>(acc, ads[j], hop::desc_mn(ks, j, T::kKVSlab), 1);
          hop::wg_commit();
          hop::wg_wait<0>();
          hop::pin(acc);
        }
        release(empty(ti));
      }
      release(q_empty(it));
      t += n_tiles;
      ++it;

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (row[i] >= Sq) continue;
        bf16* out = dq + (((int64_t)b * Sq + row[i]) * H + h) * D + 2 * t4;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
              __floats2bfloat162_rn(acc[4 * n + 2 * i] * scale,
                                    acc[4 * n + 2 * i + 1] * scale);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *dlse;
  void *dq, *dk, *dv;
  int B, Sq, Sk, H, Hkv, D, q_off, k_off, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int DMAX>
int launch_dq(const Args& a) {
  constexpr int kRows = kWarps * Own<DMAX>::R;
  const size_t smem = sizeof(float) * dq_smem_floats<DMAX>(a.D);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.H, (a.Sq + kRows - 1) / kRows);
  dq_kernel<T, DMAX><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.dlse), static_cast<T*>(a.dq), a.Sq, a.Sk,
      a.H, a.Hkv, a.D, a.q_off, a.k_off, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_dkv(const Args& a) {
  constexpr int kKeys = kWarps * Own<DMAX>::R;
  const size_t smem = sizeof(float) * dkv_smem_floats<DMAX>(a.D);
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.Hkv, (a.Sk + kKeys - 1) / kKeys);
  dkv_kernel<T, DMAX><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.dlse), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.Sq, a.Sk, a.H, a.Hkv, a.D, a.q_off, a.k_off,
      a.causal, a.scale);
  return (int)cudaGetLastError();
}

// The dk/dv kernel on the tensor cores (bf16, D = 64 or 128).
//
// A block owns 128 keys of one (b, kv head): a producer warpgroup and two
// consumer warpgroups of 64 keys each. The producer copies the block's k
// and v rows to shared memory once (TMA), then streams the query tiles
// (64 rows of q and do) through a ring of stages in the order of the FMA
// kernel: the G query heads of the group, each from the first tile whose
// rows see the block's first key. A stage also carries its rows' lse,
// delta and dlse: (B, Sq, H) keeps one head's values H floats apart,
// which no bulk copy gathers (TMA wants 16-byte strides), so the
// producer warp's lanes load them into the stage before they arrive on
// its "full" barrier; the consumers read them from shared memory. A
// consumer warpgroup forms s^T = k.q^T and dp^T = v.do^T with wgmma from
// shared memory, then p^T and ds^T in the accumulator layout (base-2
// exponent, the causal and ragged masks evaluated only on tiles that
// need them), rounds them to bf16 and feeds them as the register A
// operands of dv += p^T.do and dk += ds^T.q, with do and q read MN-major
// from the same stage. dk and dv stay in registers across the group and
// are written once: one writer per element, no atomics, sums in a fixed
// order.
template <int D> struct DkvTiles {
  static constexpr int kSlabs = D / 64;
  // consumer warpgroups of 64 keys, then one producer warp. ptxas
  // budgets registers for a block rounded up to whole warpgroups, so two
  // consumers leave 168 a thread, which the D = 128 sums (128 a thread)
  // and tiles overflow; there one consumer has 255.
  static constexpr int kConsumers = D == 64 ? 2 : 1;
  static constexpr int kBlockKeys = kConsumers * hop::kTileRows;
  static constexpr int kThreads = kConsumers * 128 + 32;
  // query rows a stage
  static constexpr int kRows = 64;
  static constexpr uint32_t kRowBytes = kRows * 128;   // one slab
  static constexpr int kStages = 4;
  // k of the block: [warpgroup][slab][64 keys][128 B]; v the same after it
  static constexpr uint32_t kKBytes = kConsumers * kSlabs * hop::kSlabBytes;
  // a stage: q [slab][kRows][128 B], do the same, then lse, delta and
  // dlse [3][kRows] f32
  static constexpr uint32_t kTileBytes = kSlabs * kRowBytes;
  static constexpr uint32_t kRowsOff = 2 * kTileBytes;
  static constexpr uint32_t kStageBytes =
      (kRowsOff + 3 * kRows * 4 + hop::kAtom - 1) / hop::kAtom * hop::kAtom;
  static constexpr uint32_t kStageOff = 2 * kKBytes;
  static constexpr uint32_t kBars = kStageOff + kStages * kStageBytes;
  static constexpr size_t kSmem = kBars + 8 * (1 + 2 * kStages) + hop::kAtom;
};

// p^T and ds^T of one tile in the accumulator layout (rows: the
// thread's keys; columns: query rows 8n + 2 t4 and + 1), rounded to bf16
// as the A operands of dv += p^T.do and dk += ds^T.q: rows 16j.. of the
// tile in [j]. p = 2^(s * scale_log2 - lse * log2(e)), one FFMA and one
// MUFU op a pair. MASKED tiles zero the pairs outside [lo[r], hi) of the
// thread's columns (key row r).
template <int R, bool MASKED>
__device__ __forceinline__ void dsp_tile(const float (&sc)[R / 2],
                                         const float (&dp)[R / 2],
                                         const float* rows, int t4,
                                         const int (&lo)[2], int hi,
                                         float scale_log2,
                                         uint32_t (&ap)[R / 16][4],
                                         uint32_t (&ads)[R / 16][4]) {
#pragma unroll
  for (int n = 0; n < R / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    const float2 ls = *reinterpret_cast<const float2*>(rows + c);
    const float2 dl = *reinterpret_cast<const float2*>(rows + R + c);
    const float2 dz = *reinterpret_cast<const float2*>(rows + 2 * R + c);
    const float lse2[2] = {ls.x * kLog2e, ls.y * kLog2e};
    float pp[4], d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + (e & 1);
      float p = hop::ex2(fmaf(sc[4 * n + e], scale_log2, -lse2[e & 1]));
      if (MASKED && (col < lo[e >> 1] || col >= hi)) p = 0.f;
      pp[e] = p;
      d[e] = p * ((dp[4 * n + e] - ((e & 1) ? dl.y : dl.x)) +
                  ((e & 1) ? dz.y : dz.x));
    }
    ap[n >> 1][(n & 1) * 2] = pack_bf16(pp[0], pp[1]);
    ap[n >> 1][(n & 1) * 2 + 1] = pack_bf16(pp[2], pp[3]);
    ads[n >> 1][(n & 1) * 2] = pack_bf16(d[0], d[1]);
    ads[n >> 1][(n & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
  }
}

template <int D>
__global__ void __launch_bounds__(DkvTiles<D>::kThreads, 1)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ dlse, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
                 int q_off, int k_off, int causal, float scale,
                 float scale_log2, int group) {
  using T = DkvTiles<D>;
  constexpr int kRowTile = T::kRows;
  constexpr uint32_t kRowTileBytes = T::kRowBytes;
  extern __shared__ uint8_t smem_tc[];
  const uint32_t base =
      (hop::saddr(smem_tc) + hop::kAtom - 1) & ~(hop::kAtom - 1);
  uint8_t* const sm = smem_tc + (base - hop::saddr(smem_tc));  // generic
  const uint32_t k_s = base, v_s = base + T::kKBytes;
  const uint32_t st_s = base + T::kStageOff;
  const uint32_t kv_full = base + T::kBars;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + T::kStages + s); };

  // Blocks go out in groups of `group` kv heads (about one wave): a
  // group's heads run together, so their q and do stay in L2, and inside
  // it the key tiles with the most live rows (the first) go first.
  const int n_kt = (Sk + T::kBlockKeys - 1) / T::kBlockKeys;
  const int n_bh = (int)(gridDim.x / n_kt);
  const int g0 = blockIdx.x / (group * n_kt) * group;
  const int in_g = min(group, n_bh - g0);
  const int j = blockIdx.x % (group * n_kt);
  const int bhk = g0 + j % in_g;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int G = H / Hkv;
  const int kb0 = j / in_g * T::kBlockKeys;
  // the first query row that sees a key of the block; each head's tiles
  // start at the tile that holds it
  const int i_blk = causal ? max(0, k_off + kb0 - q_off) : 0;
  const int qt0 = i_blk / kRowTile * kRowTile;
  const int n_rt = qt0 < Sq ? (Sq - qt0 + kRowTile - 1) / kRowTile : 0;
  const int n_tiles = G * n_rt;
  const int wg = threadIdx.x / 128;   // kConsumers: the producer warp
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hop::bar_init(kv_full, 1);
    for (int s = 0; s < T::kStages; ++s) {
      hop::bar_init(full(s), 32);                  // the producer's lanes
      hop::bar_init(empty(s), T::kConsumers * 4);   // one arrival a warp
    }
    hop::bar_init_fence();
  }
  __syncthreads();

  if (wg == T::kConsumers) {   // producer: one warp
    if (lane == 0) {
      hop::bar_arrive_tx(kv_full, 2 * T::kKBytes);
      for (int w = 0; w < T::kConsumers; ++w)
        for (int sl = 0; sl < T::kSlabs; ++sl) {
          const uint32_t at = (w * T::kSlabs + sl) * hop::kSlabBytes;
          hop::tma_load(k_s + at, &tk, kv_full, 64 * sl, hk,
                        kb0 + hop::kTileRows * w, b);
          hop::tma_load(v_s + at, &tv, kv_full, 64 * sl, hk,
                        kb0 + hop::kTileRows * w, b);
        }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % T::kStages;
      const int h = hk * G + t / n_rt, q0 = qt0 + (t % n_rt) * kRowTile;
      if (t >= T::kStages)   // the stage's previous tile is consumed
        hop::bar_wait(empty(s), ((t / T::kStages) & 1) ^ 1);
      const uint32_t st = T::kStageOff + s * T::kStageBytes;
      float* rows = reinterpret_cast<float*>(sm + st + T::kRowsOff);
      for (int i = lane; i < kRowTile; i += 32) {
        const int qi = q0 + i;
        float a = 0.f, d = 0.f, e = 0.f;
        if (qi < Sq) {
          const int64_t r = ((int64_t)b * Sq + qi) * H + h;
          a = lse[r];
          d = delta[r];
          e = dlse != nullptr ? dlse[r] : 0.f;
        }
        rows[i] = a;
        rows[kRowTile + i] = d;
        rows[2 * kRowTile + i] = e;
      }
      if (lane == 0) {
        hop::bar_arrive_tx(full(s), 2 * T::kTileBytes);
        for (int sl = 0; sl < T::kSlabs; ++sl) {
          hop::tma_load(base + st + sl * kRowTileBytes, &tq, full(s),
                        64 * sl, h, q0, b);
          hop::tma_load(base + st + T::kTileBytes + sl * kRowTileBytes,
                        &tdo, full(s), 64 * sl, h, q0, b);
        }
      } else {
        hop::bar_arrive(full(s));
      }
    }
  } else {
    const int cw = wg;
    const int warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const int kw = kb0 + cw * hop::kTileRows;   // the warpgroup's first key
    const int key[2] = {kw + warp * 16 + g, kw + warp * 16 + g + 8};
    // rows before i_wg see no key of the warpgroup; rows from i_all on
    // see all 64 (causal)
    const int i_wg = causal ? k_off + kw - q_off : INT_MIN;
    const int i_all = k_off + kw + hop::kTileRows - 1 - q_off;
    const uint32_t kw_s = k_s + cw * T::kSlabs * hop::kSlabBytes;
    const uint32_t vw_s = v_s + cw * T::kSlabs * hop::kSlabBytes;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    hop::bar_wait(kv_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % T::kStages, q0 = qt0 + (t % n_rt) * kRowTile;
      hop::bar_wait(full(s), (t / T::kStages) & 1);
      if (kw < Sk && q0 + kRowTile > i_wg) {   // warpgroup-uniform
        const uint32_t qs = st_s + s * T::kStageBytes;
        const uint32_t dos = qs + T::kTileBytes;
        const float* rows = reinterpret_cast<const float*>(
            sm + T::kStageOff + s * T::kStageBytes + T::kRowsOff);
        float sc[kRowTile / 2], dp[kRowTile / 2];
#pragma unroll
        for (int i = 0; i < kRowTile / 2; ++i) sc[i] = dp[i] = 0.f;
        hop::pin(sc);
        hop::pin(dp);
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          hop::mma_ss<kRowTile>(sc, hop::desc_k(kw_s, kk, hop::kSlabBytes),
                                hop::desc_k(qs, kk, kRowTileBytes), kk > 0);
          hop::mma_ss<kRowTile>(dp, hop::desc_k(vw_s, kk, hop::kSlabBytes),
                                hop::desc_k(dos, kk, kRowTileBytes), kk > 0);
        }
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::pin(sc);
        hop::pin(dp);
        // masks only where some (row, key) pair of the tile is dead: past
        // Sq or Sk, or before the causal diagonal
        const bool masked = q0 + kRowTile > Sq || kw + hop::kTileRows > Sk ||
                            (causal && q0 < i_all);
        // the thread's columns c = 8n + 2 t4 (+1) are live for key row r
        // from lo[r] on and below hi
        const int hi = Sq - q0 - 2 * t4;
        const int lo[2] = {
            key[0] >= Sk ? INT_MAX
                         : (causal ? k_off + key[0] - q_off - q0 : -kWide) -
                               2 * t4,
            key[1] >= Sk ? INT_MAX
                         : (causal ? k_off + key[1] - q_off - q0 : -kWide) -
                               2 * t4};
        uint32_t ap[kRowTile / 16][4], ads[kRowTile / 16][4];
        if (masked)
          dsp_tile<kRowTile, true>(sc, dp, rows, t4, lo, hi, scale_log2, ap,
                                   ads);
        else
          dsp_tile<kRowTile, false>(sc, dp, rows, t4, lo, hi, scale_log2, ap,
                                    ads);
        hop::pin(dv_acc);
        hop::pin(dk_acc);
        hop::wg_fence();
#pragma unroll
        for (int j = 0; j < kRowTile / 16; ++j) {
          hop::mma_rs<D>(dv_acc, ap[j], hop::desc_mn(dos, j, kRowTileBytes),
                         1);
          hop::mma_rs<D>(dk_acc, ads[j], hop::desc_mn(qs, j, kRowTileBytes),
                         1);
        }
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::pin(dv_acc);
        hop::pin(dk_acc);
      }
      __syncwarp();
      if (lane == 0) hop::bar_arrive(empty(s));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key[i] >= Sk) continue;
      const int64_t at = (((int64_t)b * Sk + key[i]) * Hkv + hk) * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + n * 8) =
            __floats2bfloat162_rn(dk_acc[4 * n + 2 * i] * scale,
                                  dk_acc[4 * n + 2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + n * 8) =
            __floats2bfloat162_rn(dv_acc[4 * n + 2 * i],
                                  dv_acc[4 * n + 2 * i + 1]);
      }
    }
  }
}

template <int D>
int launch_dkv_wgmma(const Args& a) {
  using T = DkvTiles<D>;
  CUtensorMap tq, tdo, tk, tv;
  int rc = hop::make_map(&tq, a.q, D, a.H, a.Sq, a.B, T::kRows);
  if (rc == 0) rc = hop::make_map(&tdo, a.dout, D, a.H, a.Sq, a.B, T::kRows);
  if (rc == 0)
    rc = hop::make_map(&tk, a.k, D, a.Hkv, a.Sk, a.B, hop::kTileRows);
  if (rc == 0)
    rc = hop::make_map(&tv, a.v, D, a.Hkv, a.Sk, a.B, hop::kTileRows);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      dkv_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (a.Sk + T::kBlockKeys - 1) / T::kBlockKeys;
  dkv_wgmma_kernel<D><<<(unsigned)a.B * a.Hkv * n_kt, T::kThreads, T::kSmem,
                        a.stream>>>(
      tq, tdo, tk, tv, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.dlse),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Sq, a.Sk, a.H,
      a.Hkv, a.q_off, a.k_off, a.causal, a.scale, a.scale * kLog2e,
      std::max(1, hop::sm_count() / n_kt));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_wgmma(const Args& a) {
  using T = DqTiles<D>;
  CUtensorMap tq, tdo, tk, tv;
  int rc = hop::make_map(&tq, a.q, D, a.H, a.Sq, a.B, hop::kTileRows);
  if (rc == 0)
    rc = hop::make_map(&tdo, a.dout, D, a.H, a.Sq, a.B, hop::kTileRows);
  if (rc == 0) rc = hop::make_map(&tk, a.k, D, a.Hkv, a.Sk, a.B, T::kKeyTile);
  if (rc == 0) rc = hop::make_map(&tv, a.v, D, a.Hkv, a.Sk, a.B, T::kKeyTile);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      dq_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  // one block an SM at most: `group` heads at a time, one block for each
  // of their query tiles
  const int n_qt = (a.Sq + T::kBlockRows - 1) / T::kBlockRows;
  const int group =
      std::max(1, std::min(a.B * a.H, hop::sm_count() / n_qt));
  dq_wgmma_kernel<D><<<(unsigned)group * n_qt, T::kThreads, T::kSmem,
                       a.stream>>>(
      tq, tdo, tk, tv, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.dlse),
      static_cast<bf16*>(a.dq), a.B, a.Sq, a.Sk, a.H, a.Hkv, a.q_off,
      a.k_off, a.causal, a.scale, a.scale * kLog2e, group);
  return (int)cudaGetLastError();
}

// The tensor-core path takes bf16 at D = 64 or 128 with the q, k, v and
// do rows 16-byte aligned (the tensor maps' base addresses); everything
// else takes the FMA path.
bool mma_path(int dtype, const Args& a) {
  const void* const ptrs[4] = {a.q, a.k, a.v, a.dout};
  return dtype == 1 && mma_rows_ok(ptrs, 4, a.D);
}

template <bool DQ, typename T>
int dispatch_dim(const Args& a) {
  if (a.D <= 64) return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
  if (a.D <= 128) return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
  return DQ ? launch_dq<T, 256>(a) : launch_dkv<T, 256>(a);
}

template <bool DQ>
int dispatch(int dtype, const Args& a) {
  if (a.B == 0 || a.H == 0 || a.Sq == 0 || a.Sk == 0) return 0;
  if (mma_path(dtype, a)) {
    if (a.D == 64)
      return DQ ? launch_dq_wgmma<64>(a) : launch_dkv_wgmma<64>(a);
    return DQ ? launch_dq_wgmma<128>(a) : launch_dkv_wgmma<128>(a);
  }
  return dtype == 1 ? dispatch_dim<DQ, __nv_bfloat16>(a)
                    : dispatch_dim<DQ, float>(a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do, dq, dk, dv alike); lse,
// delta and dlse f32, dlse may be null; scale = 1/sqrt(D) rounded to f32
// by the caller. Returns a cudaError_t (0 = success). The Python wrapper
// has checked shapes (D <= 256, H % Hkv == 0), dtypes, devices and
// contiguity. bps_flash_bwd_dq writes dq; bps_flash_bwd_dkv writes dk, dv.
extern "C" int bps_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* dlse, void* dq,
                                int dtype, int B, int Sq, int Sk, int H,
                                int Hkv, int D, int q_off, int k_off,
                                int causal, float scale, void* stream) {
  const Args a{q,  k,  v,   dout, lse,   delta, dlse,  dq,     nullptr,
               nullptr, B, Sq, Sk, H, Hkv, D, q_off, k_off, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, a);
}

extern "C" int bps_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* dlse,
                                 void* dk, void* dv, int dtype, int B, int Sq,
                                 int Sk, int H, int Hkv, int D, int q_off,
                                 int k_off, int causal, float scale,
                                 void* stream) {
  const Args a{q,  k,  v,  dout, lse, delta, dlse, nullptr, dk, dv,
               B, Sq, Sk, H, Hkv, D, q_off, k_off, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, a);
}
