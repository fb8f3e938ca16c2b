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
// tensor cores (dq_mma_kernel, dkv_mma_kernel, below); f32 and every
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
// load; the tensor-core path puts 16 on a warp against 64-wide tiles.
//
// What bounds it. At GPT-2 medium's training shape (B*H = 128, S = 1024,
// D = 64, causal) the work is 6*D (dq) and 8*D (dkv) FLOPs per live
// (row, key) pair, about 25 and 34 GFLOP a layer, against a few tens of
// MB of inputs and outputs: operations bound, at 989 TFLOP/s bf16 on the
// tensor cores and 67 TFLOP/s f32 on the CUDA cores of an H100 SXM. The
// tensor-core path stages each tile without overlapping the next load
// (no cp.async or TMA pipeline) and runs two blocks an SM at these
// register counts; wgmma tiles and a pipelined staging are later work.
#include "attn_common.cuh"

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
// The same two kernels with the products on the tensor cores (the mma
// pieces of attn_common.cuh). A block owns 64 query rows (dq) or 64 keys
// (dk/dv), 16 a warp, and walks 64-wide shared tiles of the other side.
// s and dp come out in the accumulator layout, where a thread holds two
// of the warp's 16 rows; p and ds are formed there, rounded to bf16 (the
// rounding above), and fed to the next product as its A operand. Sums
// over keys (dq) and rows (dk, dv) run in the tensor cores' order, so the
// two paths agree to rounding, not bit for bit.
// ---------------------------------------------------------------------------
constexpr int kMmaRows = 64;  // rows (dq) or keys (dkv) of a block, 16 a warp

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * 4 * kMmaTile * (D + 8) + sizeof(float) * 3 * kMmaTile;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const float* __restrict__ dlse, bf16* __restrict__ dq, int Sq,
              int Sk, int H, int Hkv, int q_off, int k_off, int causal,
              float scale) {
  constexpr int LD = D + 8;
  extern __shared__ uint4 smem_mma[];
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);  // [64][LD] query rows
  bf16* dos = qs + kMmaRows * LD;                // [64][LD]
  bf16* ks = dos + kMmaRows * LD;                // [64][LD] key tile
  bf16* vs = ks + kMmaTile * LD;                 // [64][LD]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kMmaRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t q_pos = (int64_t)H * D, kv_pos = (int64_t)Hkv * D;
  const int64_t q_at = ((int64_t)b * Sq + q0) * q_pos + (int64_t)h * D;
  const bf16* kb = k + (int64_t)b * Sk * kv_pos + (int64_t)hk * D;
  const bf16* vb = v + (int64_t)b * Sk * kv_pos + (int64_t)hk * D;
  {
    bf16* const dst[2] = {qs, dos};
    const bf16* const src[2] = {q + q_at, dout + q_at};
    stage_bf16<D, kThreads, 2>(dst, src, q_pos, min(kMmaRows, Sq - q0),
                               threadIdx.x);
  }

  // the thread's rows: w0 + g and w0 + g + 8
  const int w0 = q0 + warp * 16;
  float lse_r[2], delta_r[2], dlse_r[2];
  int end_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = w0 + g + 8 * i;
    lse_r[i] = delta_r[i] = dlse_r[i] = 0.f;
    end_r[i] = 0;
    if (qi < Sq) {
      const int64_t row = ((int64_t)b * Sq + qi) * H + h;
      lse_r[i] = lse[row];
      delta_r[i] = delta[row];
      dlse_r[i] = dlse != nullptr ? dlse[row] : 0.f;
      end_r[i] = live_end(qi, Sk, q_off, k_off, causal);
    }
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
    __syncthreads();  // the previous tile is consumed (and qs/dos written)
    {
      bf16* const dst[2] = {ks, vs};
      const bf16* const src[2] = {kb + k0 * kv_pos, vb + k0 * kv_pos};
      stage_bf16<D, kThreads, 2>(dst, src, kv_pos, min(kMmaTile, Sk - k0),
                                 threadIdx.x);
    }
    __syncthreads();
    if (k0 >= warp_end) continue;  // warp-uniform: no live key for its rows
    float s[kMmaTile / 8][4], dp[kMmaTile / 8][4];
#pragma unroll
    for (int n = 0; n < kMmaTile / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t aq[4], ado[4];
      load_a(aq, qs, LD, warp * 16, kk, lane);
      load_a(ado, dos, LD, warp * 16, kk, lane);
#pragma unroll
      for (int n = 0; n < kMmaTile; n += 16) {
        uint32_t bk[4], bv[4];
        load_b_nk(bk, ks, LD, n, kk, lane);
        load_b_nk(bv, vs, LD, n, kk, lane);
        mma_bf16(s[n / 8], aq, bk[0], bk[1]);
        mma_bf16(s[n / 8 + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[n / 8], ado, bv[0], bv[1]);
        mma_bf16(dp[n / 8 + 1], ado, bv[2], bv[3]);
      }
    }
    // ds on the accumulator layout (c0, c1: row g; c2, c3: row g + 8;
    // columns 2t, 2t + 1 of each 8-key tile), as A operands of dq += ds.k
    uint32_t ads[kMmaTile / 16][4];
#pragma unroll
    for (int n = 0; n < kMmaTile / 8; ++n) {
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int key = k0 + n * 8 + 2 * t + (i & 1);
        const float p =
            key < end_r[r] ? expf(s[n][i] * scale - lse_r[r]) : 0.f;
        d[i] = p * ((dp[n][i] - delta_r[r]) + dlse_r[r]);
      }
      ads[n >> 1][(n & 1) * 2] = pack_bf16(d[0], d[1]);
      ads[n >> 1][(n & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
    }
#pragma unroll
    for (int j = 0; j < kMmaTile / 16; ++j)
#pragma unroll
      for (int n = 0; n < D; n += 16) {
        uint32_t bk[4];
        load_b_kn(bk, ks, LD, n, j * 16, lane);
        mma_bf16(acc[n / 8], ads[j], bk[0], bk[1]);
        mma_bf16(acc[n / 8 + 1], ads[j], bk[2], bk[3]);
      }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = w0 + g + 8 * i;
    if (qi >= Sq) continue;
    bf16* out = dq + (((int64_t)b * Sq + qi) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const float* __restrict__ dlse, bf16* __restrict__ dk,
               bf16* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
               int q_off, int k_off, int causal, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ uint4 smem_mma[];
  bf16* ks = reinterpret_cast<bf16*>(smem_mma);  // [64][LD] the block's keys
  bf16* vs = ks + kMmaRows * LD;                 // [64][LD]
  bf16* qs = vs + kMmaRows * LD;                 // [64][LD] query tile
  bf16* dos = qs + kMmaTile * LD;                // [64][LD]
  float* lse_s = reinterpret_cast<float*>(dos + kMmaTile * LD);  // [64]
  float* delta_s = lse_s + kMmaTile;                             // [64]
  float* dlse_s = delta_s + kMmaTile;                            // [64]

  const int bhk = blockIdx.x;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int G = H / Hkv;
  const int kb0 = blockIdx.y * kMmaRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t q_pos = (int64_t)H * D, kv_pos = (int64_t)Hkv * D;
  {
    const int64_t at = ((int64_t)b * Sk + kb0) * kv_pos + (int64_t)hk * D;
    bf16* const dst[2] = {ks, vs};
    const bf16* const src[2] = {k + at, v + at};
    stage_bf16<D, kThreads, 2>(dst, src, kv_pos, min(kMmaRows, Sk - kb0),
                               threadIdx.x);
  }
  const int key0 = kb0 + warp * 16;  // the warp's first key
  // the first query row that sees a key of the block, and of the warp
  const int i_blk = causal ? max(0, k_off + kb0 - q_off) : 0;
  const int i_warp = causal ? max(0, k_off + key0 - q_off) : 0;
  const int qt0 = (i_blk / kMmaTile) * kMmaTile;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;

  for (int hg = 0; hg < G; ++hg) {
    const int h = hk * G + hg;
    for (int q0 = qt0; q0 < Sq; q0 += kMmaTile) {
      __syncthreads();  // the previous tile is consumed (and ks/vs written)
      {
        const int64_t at = ((int64_t)b * Sq + q0) * q_pos + (int64_t)h * D;
        bf16* const dst[2] = {qs, dos};
        const bf16* const src[2] = {q + at, dout + at};
        stage_bf16<D, kThreads, 2>(dst, src, q_pos, min(kMmaTile, Sq - q0),
                                   threadIdx.x);
      }
      for (int i = threadIdx.x; i < kMmaTile; i += kThreads) {
        const int qi = q0 + i;
        const int64_t row = ((int64_t)b * Sq + qi) * H + h;
        lse_s[i] = qi < Sq ? lse[row] : 0.f;
        delta_s[i] = qi < Sq ? delta[row] : 0.f;
        dlse_s[i] = qi < Sq && dlse != nullptr ? dlse[row] : 0.f;
      }
      __syncthreads();
      // warp-uniform: no row of the tile sees a key of the warp
      if (key0 >= Sk || q0 + kMmaTile <= i_warp) continue;
      // s^T and dp^T: the warp's 16 keys against the tile's 64 rows
      float s[kMmaTile / 8][4], dp[kMmaTile / 8][4];
#pragma unroll
      for (int n = 0; n < kMmaTile / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t ak[4], av[4];
        load_a(ak, ks, LD, warp * 16, kk, lane);
        load_a(av, vs, LD, warp * 16, kk, lane);
#pragma unroll
        for (int n = 0; n < kMmaTile; n += 16) {
          uint32_t bq[4], bo[4];
          load_b_nk(bq, qs, LD, n, kk, lane);
          load_b_nk(bo, dos, LD, n, kk, lane);
          mma_bf16(s[n / 8], ak, bq[0], bq[1]);
          mma_bf16(s[n / 8 + 1], ak, bq[2], bq[3]);
          mma_bf16(dp[n / 8], av, bo[0], bo[1]);
          mma_bf16(dp[n / 8 + 1], av, bo[2], bo[3]);
        }
      }
      // p^T and ds^T (rows: keys g, g + 8 of the warp; columns: query
      // rows 2t, 2t + 1 of each 8-row tile), as A operands
      uint32_t ap[kMmaTile / 16][4], ads[kMmaTile / 16][4];
#pragma unroll
      for (int n = 0; n < kMmaTile / 8; ++n) {
        float pp[4], d[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = key0 + g + 8 * (i >> 1);
          const int ri = n * 8 + 2 * t + (i & 1), qi = q0 + ri;
          const bool live = qi < Sq && key < Sk &&
                            (!causal || q_off + qi >= k_off + key);
          const float p = live ? expf(s[n][i] * scale - lse_s[ri]) : 0.f;
          pp[i] = p;
          d[i] = p * ((dp[n][i] - delta_s[ri]) + dlse_s[ri]);
        }
        ap[n >> 1][(n & 1) * 2] = pack_bf16(pp[0], pp[1]);
        ap[n >> 1][(n & 1) * 2 + 1] = pack_bf16(pp[2], pp[3]);
        ads[n >> 1][(n & 1) * 2] = pack_bf16(d[0], d[1]);
        ads[n >> 1][(n & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
      }
      // dv += p^T.do, dk += ds^T.q over the tile's rows
#pragma unroll
      for (int j = 0; j < kMmaTile / 16; ++j)
#pragma unroll
        for (int n = 0; n < D; n += 16) {
          uint32_t bo[4], bq[4];
          load_b_kn(bo, dos, LD, n, j * 16, lane);
          load_b_kn(bq, qs, LD, n, j * 16, lane);
          mma_bf16(dv_acc[n / 8], ap[j], bo[0], bo[1]);
          mma_bf16(dv_acc[n / 8 + 1], ap[j], bo[2], bo[3]);
          mma_bf16(dk_acc[n / 8], ads[j], bq[0], bq[1]);
          mma_bf16(dk_acc[n / 8 + 1], ads[j], bq[2], bq[3]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + g + 8 * i;
    if (key >= Sk) continue;
    const int64_t at = (((int64_t)b * Sk + key) * Hkv + hk) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + n * 8) =
          __floats2bfloat162_rn(dk_acc[n][2 * i] * scale,
                                dk_acc[n][2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + n * 8) =
          __floats2bfloat162_rn(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
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

template <int D>
int launch_dq_mma(const Args& a) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.H, (a.Sq + kMmaRows - 1) / kMmaRows);
  dq_mma_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.dlse), static_cast<bf16*>(a.dq), a.Sq,
      a.Sk, a.H, a.Hkv, a.q_off, a.k_off, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_mma(const Args& a) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dkv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.Hkv, (a.Sk + kMmaRows - 1) / kMmaRows);
  dkv_mma_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.dlse), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.Sq, a.Sk, a.H, a.Hkv, a.q_off, a.k_off,
      a.causal, a.scale);
  return (int)cudaGetLastError();
}

// The tensor-core path takes bf16 at D = 64 or 128 with the q, k, v and
// do rows 16-byte aligned (its 16-byte staging loads); everything else
// takes the FMA path.
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
    if (a.D == 64) return DQ ? launch_dq_mma<64>(a) : launch_dkv_mma<64>(a);
    return DQ ? launch_dq_mma<128>(a) : launch_dkv_mma<128>(a);
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
