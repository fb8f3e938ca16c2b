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
// against 3.35 TB/s, bound it.
//
// Design. One block per (kv head, sequence). Its warps split the live
// prefix into 32-key tiles (warp w takes tiles w, w + nw, ...), so every
// key is read from device memory once, by one warp, in 16-byte vectors
// all in flight together, and staged (dequantized) in that warp's shared
// tile. The G query heads of
// the group all fold that one staged tile into their own online-softmax
// state, which lives in shared memory per (warp, head). At the end the
// warps' partial states merge by their row maxima. Work is skipped past
// pos at tile granularity and masked inside the last tile.
#include <algorithm>
#include <type_traits>

#include "attn_common.cuh"

namespace {

using namespace bps;

constexpr int kMaxWarps = 8;

template <typename T, typename C, int DMAX>
__global__ void __launch_bounds__(kMaxWarps * 32)
decode_kernel(const T* __restrict__ q, const C* __restrict__ k,
              const C* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, T* __restrict__ o, int S,
              int Hkv, int G, int D, int live, float scale) {
  constexpr bool quant = std::is_same<C, int8_t>::value;
  extern __shared__ float smem[];
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = tile_ld(D);
  const int st_ld = D + 2;                      // m, l, acc[D]
  float* qs = smem;                             // [G][D]
  float* ks = qs + G * D + warp * 2 * kTileKeys * ld;  // this warp's tiles
  float* vs = ks + kTileKeys * ld;
  float* st = qs + G * D + nw * 2 * kTileKeys * ld;    // [nw][G][st_ld]
  float* my = st + warp * G * st_ld;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int64_t head0 = ((int64_t)b * Hkv + hk) * G * D;  // q/o offset
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x)
    qs[idx] = to_f32(q[head0 + idx]);
  for (int idx = lane; idx < G * st_ld; idx += 32)
    my[idx] = (idx % st_ld == 0) ? kNeg : 0.f;
  __syncthreads();

  const int ntiles = (live + kTileKeys - 1) / kTileKeys;
  for (int t = warp; t < ntiles; t += nw) {
    const int k0 = t * kTileKeys;
    const int n = min(kTileKeys, live - k0);
    __syncwarp();  // the previous tile is consumed
    const int64_t row0 = ((int64_t)b * S + k0) * Hkv + hk;  // key k0's row
    float* const dst[2] = {ks, vs};
    const C* const src[2] = {k + row0 * D, v + row0 * D};
    const float* const sc[2] = {quant ? k_scale + row0 : nullptr,
                                quant ? v_scale + row0 : nullptr};
    stage_rows<T, C, 32, 2>(dst, ld, src, (int64_t)Hkv * D, sc, Hkv, n, D,
                            lane);
    __syncwarp();
    const int n_live[1] = {n};
    for (int g = 0; g < G; ++g) {
      float* sg = my + g * st_ld;
      float m[1] = {sg[0]}, l[1] = {sg[1]};
      float acc[1][DMAX / 32];
#pragma unroll
      for (int i = 0; i < DMAX / 32; ++i) {
        const int d = lane + 32 * i;
        acc[0][i] = d < D ? sg[2 + d] : 0.f;
      }
      fold_rows<1, DMAX>(qs + g * D, ks, vs, ld, D, n_live, scale, m, l, acc);
#pragma unroll
      for (int i = 0; i < DMAX / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < D) sg[2 + d] = acc[0][i];
      }
      __syncwarp();  // every lane has read m, l before lane 0 rewrites them
      if (lane == 0) {
        sg[0] = m[0];
        sg[1] = l[0];
      }
    }
  }
  __syncthreads();

  // merge the warps' partial states, one query head per warp at a time
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
    const float l_safe = l > 0.f ? l : 1.f;
#pragma unroll
    for (int i = 0; i < DMAX / 32; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o[head0 + (int64_t)g * D + d] = from_f32<T>(acc[i] / l_safe);
    }
  }
}

size_t smem_bytes(int nw, int G, int D) {
  return sizeof(float) *
         ((size_t)G * D + (size_t)nw * 2 * kTileKeys * tile_ld(D) +
          (size_t)nw * G * (D + 2));
}

template <typename T, typename C, int DMAX>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, void* o, int B, int S, int Hkv, int G, int D,
           int live, float scale, cudaStream_t stream) {
  // as many warps as the live tiles can use and shared memory allows
  int nw = std::min(kMaxWarps, (live + kTileKeys - 1) / kTileKeys);
  const size_t cap = 200 * 1024;
  while (nw > 1 && smem_bytes(nw, G, D) > cap) --nw;
  const size_t smem = smem_bytes(nw, G, D);
  if (smem > cap) return (int)cudaErrorInvalidValue;
  auto kern = decode_kernel<T, C, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(Hkv, B), nw * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const C*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<T*>(o), S, Hkv, G, D, live,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, typename C>
int dispatch_dim(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, void* o, int B, int S, int Hkv, int G, int D,
                 int live, float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, C, 64>(q, k, v, ks, vs, o, B, S, Hkv, G, D, live, scale,
                            stream);
  if (D <= 128)
    return launch<T, C, 128>(q, k, v, ks, vs, o, B, S, Hkv, G, D, live, scale,
                             stream);
  return launch<T, C, 256>(q, k, v, ks, vs, o, B, S, Hkv, G, D, live, scale,
                           stream);
}

template <typename T>
int dispatch_cache(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, void* o, int quant, int B, int S, int Hkv,
                   int G, int D, int live, float scale, cudaStream_t stream) {
  if (quant)
    return dispatch_dim<T, int8_t>(q, k, v, ks, vs, o, B, S, Hkv, G, D, live,
                                   scale, stream);
  return dispatch_dim<T, T>(q, k, v, ks, vs, o, B, S, Hkv, G, D, live, scale,
                            stream);
}

}  // namespace

// dtype (of q, o and a dense cache): 0 = float32, 1 = bfloat16. quant: the
// cache is int8 and k_scale / v_scale are given. pos: the query's global
// position (0 <= pos < S). scale = 1/sqrt(D) rounded to f32 by the caller.
// Returns a cudaError_t (0 = success). The Python wrapper has checked
// shapes, dtypes, devices and contiguity.
extern "C" int bps_flash_decode(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                void* o, int dtype, int quant, int B, int S,
                                int Hkv, int G, int D, int pos, float scale,
                                void* stream) {
  if (B == 0 || Hkv == 0 || G == 0) return 0;
  const int live = std::min(pos + 1, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_cache<__nv_bfloat16>(q, k, v, k_scale, v_scale, o, quant,
                                         B, S, Hkv, G, D, live, scale, s);
  return dispatch_cache<float>(q, k, v, k_scale, v_scale, o, quant, B, S, Hkv,
                               G, D, live, scale, s);
}
