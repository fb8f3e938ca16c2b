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
// for the merge; the tensor-core path needs none. wgmma tiles are later
// work.
#include <algorithm>

#include "attn_common.cuh"

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
// prefills. One block per (b*h, 64-row query tile), 16 rows a warp,
// walking 64-key tiles in order with no splits. s comes out of the mma
// (attn_common.cuh) in the accumulator layout, where a quad of lanes
// holds one row's 64 keys; the online softmax runs there, and p, rounded
// to bf16 as the reference's kernel rounds it for its MXU, is the A
// operand of o += p.v. l sums the unrounded p. Short chunks (the serving
// tier's) keep the split path above, which spreads one chunk's keys over
// blocks; f32 always takes it.
// ---------------------------------------------------------------------------
constexpr int kMmaRows = 64;         // query rows of a block, 16 a warp
constexpr int kMmaMinBlocks = 128;   // about one block per SM (132)

bool use_mma(int dtype, int aligned, int B, int Sq, int H, int D) {
  return dtype == 1 && aligned && (D == 64 || D == 128) &&
         (int64_t)B * H * ((Sq + kMmaRows - 1) / kMmaRows) >= kMmaMinBlocks;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
               int q_off, int k_off, int causal, float scale) {
  constexpr int LD = D + 8, NT = kWarps * 32;
  extern __shared__ uint4 smem_mma[];
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);  // [64][LD] query rows
  bf16* ks = qs + kMmaRows * LD;                 // [64][LD] key tile
  bf16* vs = ks + kMmaTile * LD;                 // [64][LD]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kMmaRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t q_pos = (int64_t)H * D, kv_pos = (int64_t)Hkv * D;
  const bf16* kb = k + (int64_t)b * Sk * kv_pos + (int64_t)hk * D;
  const bf16* vb = v + (int64_t)b * Sk * kv_pos + (int64_t)hk * D;
  {
    bf16* const dst[1] = {qs};
    const bf16* const src[1] = {q + ((int64_t)b * Sq + q0) * q_pos +
                                (int64_t)h * D};
    stage_bf16<D, NT, 1>(dst, src, q_pos, min(kMmaRows, Sq - q0),
                         threadIdx.x);
  }

  // the thread's rows: w0 + g and w0 + g + 8
  const int w0 = q0 + warp * 16;
  int end_r[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = w0 + g + 8 * i;
    end_r[i] = qi < Sq ? live_end(qi, Sk, q_off, k_off, causal) : 0;
    m[i] = kNeg;
    l[i] = 0.f;
  }
  const int warp_end =
      w0 < Sq ? live_end(min(w0 + 15, Sq - 1), Sk, q_off, k_off, causal) : 0;
  const int kend = live_end(min(q0 + kMmaRows, Sq) - 1, Sk, q_off, k_off,
                            causal);
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kMmaTile) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    {
      bf16* const dst[2] = {ks, vs};
      const bf16* const src[2] = {kb + k0 * kv_pos, vb + k0 * kv_pos};
      stage_bf16<D, NT, 2>(dst, src, kv_pos, min(kMmaTile, Sk - k0),
                           threadIdx.x);
    }
    __syncthreads();
    if (k0 >= warp_end) continue;  // warp-uniform: no live key for its rows
    float s[kMmaTile / 8][4];
#pragma unroll
    for (int n = 0; n < kMmaTile / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t aq[4];
      load_a(aq, qs, LD, warp * 16, kk, lane);
#pragma unroll
      for (int n = 0; n < kMmaTile; n += 16) {
        uint32_t bk[4];
        load_b_nk(bk, ks, LD, n, kk, lane);
        mma_bf16(s[n / 8], aq, bk[0], bk[1]);
        mma_bf16(s[n / 8 + 1], aq, bk[2], bk[3]);
      }
    }
    // mask and scale; the row maxima over the quad that holds each row
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int n = 0; n < kMmaTile / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + n * 8 + 2 * t + (i & 1);
        s[n][i] = key < end_r[i >> 1] ? s[n][i] * scale : kNeg;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      mx[r] = fmaxf(m[r], mx[r]);
    }
    float sum[2] = {0.f, 0.f};
    uint32_t ap[kMmaTile / 16][4];
#pragma unroll
    for (int n = 0; n < kMmaTile / 8; ++n) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = s[n][i] > 0.5f * kNeg ? expf(s[n][i] - mx[i >> 1]) : 0.f;
        sum[i >> 1] += p[i];
      }
      ap[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      ap[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
      sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
      alpha[r] = expf(m[r] - mx[r]);
      l[r] = l[r] * alpha[r] + sum[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= alpha[i >> 1];
#pragma unroll
    for (int j = 0; j < kMmaTile / 16; ++j)
#pragma unroll
      for (int n = 0; n < D; n += 16) {
        uint32_t bv[4];
        load_b_kn(bv, vs, LD, n, j * 16, lane);
        mma_bf16(acc[n / 8], ap[j], bv[0], bv[1]);
        mma_bf16(acc[n / 8 + 1], ap[j], bv[2], bv[3]);
      }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = w0 + g + 8 * i;
    if (qi >= Sq) continue;
    const int64_t row = ((int64_t)b * Sq + qi) * H + h;
    const float l_safe = l[i] > 0.f ? l[i] : 1.f;
    bf16* out = o + row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * i] / l_safe, acc[n][2 * i + 1] / l_safe);
    if (t == 0) lse[row] = l[i] > 0.f ? m[i] + logf(l_safe) : kNeg;
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Sq, int Sk, int H, int Hkv, int q_off,
               int k_off, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = sizeof(bf16) * 3 * kMmaTile * (D + 8);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + kMmaRows - 1) / kMmaRows);
  fwd_mma_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), Sq, Sk, H, Hkv, q_off, k_off, causal, scale);
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
      return launch_mma<64>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, q_off, k_off,
                            causal, scale, s);
    return launch_mma<128>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, q_off, k_off,
                           causal, scale, s);
  }
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(q, k, v, o, lse, ws, B, Sq, Sk, H, Hkv,
                                       D, q_off, k_off, causal, scale, s);
  return dispatch_dim<float>(q, k, v, o, lse, ws, B, Sq, Sk, H, Hkv, D, q_off,
                             k_off, causal, scale, s);
}
