// Onebit sign codec for Hopper (sm_90a): pack and the fused unpack-sum.
//
// Replaces byteps_tpu/ops/onebit_kernels.py:_pack_kernel (via _pack_pallas),
// :_make_unpack_sum_kernel (via _unpack_sum_pallas, K <= 32 workers) and
// :_make_unpack_sum_grid_kernel (the same call, K > 32).
// Wire layout (the reference's, kept bit for bit): n f32 values, padded
// with zeros to 32 * L, are viewed as (32, L); bit k of word j is
// x[k * L + j] >= 0. So padding packs as 1, -0.0 as 1 and NaN as 0.
// Words are 32-bit; the Python side holds them as int32 with the uint32
// bits.
//
// pack: a thread owns kPackWords = 2 adjacent word columns j, j + 1 and
// reads bit row k of both as one 8-byte vector x[k * L + j ..], coalesced
// across the warp (256 contiguous bytes a row), all 32 in flight before
// any is used, then stores the two words as one 8-byte vector; blocks of
// 128 threads (a 1,024,000-element chunk, L = 32,000, is 125 blocks). A
// thread whose 32 vectors all lie below n (and x on 8 bytes) loads them
// with no branch or predicate between them; the others (the columns
// that reach n, about a ninth of a ragged chunk's, or every column where
// x is off 8 bytes) go row by row: a whole vector where it lies below
// n, else element by element, elements at or past n reading as 0.0, so
// the caller never pads. On an H100, warm (the input just written, as
// error feedback leaves it), a ballot transpose (lane k reading bit row
// k in 16-byte vectors, one __ballot_sync a word), 4 words a thread, and
// a vector-or-scalar choice on every row were slower than one word a
// thread with 32 scalar loads; this form was a little faster than that,
// warm and cold. Cold, every form reads its 4 MB about as fast as `ge`
// or copy_ read the same 4 MB.
//
// unpack_sum (K <= 32): a thread owns 2 adjacent word columns j, j+1
// and kRowsPerThread = 8 of their 32 bit rows k (4 threads a column, in
// 4 warps of one block; the 32,000 words of a full chunk give 64,000
// threads). A warp takes 32 adjacent column pairs, so for payload r it
// reads 256 consecutive bytes of words, one 8-byte vector a lane: each
// word once per payload and warp (the 4 warps of a column share their
// block's L1), the words of 16 payloads in flight at once. One thread per
// element used to read each word in 32 threads of 32 blocks. The block
// reads scales[0..K) once into shared memory. For each of its bit rows k
// and columns a thread folds r = 0..K-1 from 0.0f with
// acc = __fadd_rn(acc, bit ? s_r : -s_r), the reference's
// _rows_unpack_acc sum, term for term, so the result is the plain
// version's bit for bit. It stores row k's two elements out[k * L + j..]
// as one 8-byte vector (L from packed_words is a multiple of 128; an odd
// L, which it never gives, loads and stores a word or an element at a
// time), coalesced across the warp; the elements at or past n (ragged n)
// are masked. Offsets are
// products, never a division. Two columns a thread keep the word loads
// and the stores vectors while a chunk still fills the card; on an H100
// it was faster than 1 or 4 columns (by 4, 8 or 16 rows) at K = 32 and
// about as fast at K = 1 and 2.
//
// unpack_sum_grid (K > 32): the same layout and loads (each word read
// once per warp, no division), the scales loaded beside the words (K has
// no bound, so no fixed table holds them), and the reference grid
// kernel's order of adds: rows in blocks of 8, each block folded from
// 0.0f, the output block 0 then + block b in block order (see
// unpack_sum_body). It used to run one thread per element e = k * L + j
// (k and j by a division), reading each word in 32 threads of 32 blocks.
// On an H100 a column a thread (twice the warps), and loading the next
// row block while adding the last, were both slower at K = 40 and 256.
//
// What bounds them: bytes. A 1,024,000-element chunk (the default
// 4,096,000-byte partition) moves 4 MB of f32 and 128 KB of words each
// way, about 1.3 us at 3.35 TB/s; at that size a launch costs about as
// much as the transfer. Unpack-sum's and pack's stores are 8-byte
// vectors, and so are pack's loads. At large K the unpack-sums' issue
// rate comes first: a term is a shift, a LOP3 and an add, so K = 256 on a
// chunk (2.6e8 terms) takes about 26 us of issue on 132 SMs at 1.75 GHz
// against 11 us of bytes (on an H100 the grid kernel took 45 us).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPackThreads = 128;
constexpr int kPackWords = 2;     // adjacent word columns a pack thread
constexpr int kGridRows = 8;      // the reference grid kernel's row block
constexpr int kUnrollK = 32;      // the most payloads unpack_sum takes
// unpack_sum: bit rows a thread (of 2 adjacent word columns), row groups
// a column, strips of 64 columns a block (each strip one warp per row
// group), payloads whose words a thread loads before adding them
constexpr int kRowsPerThread = 8;
constexpr int kRowGroups = 32 / kRowsPerThread;
constexpr int kStrips = kThreads / 32 / kRowGroups;
constexpr int kLoadBatch = 16;

__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const float* __restrict__ x, uint32_t* __restrict__ words,
            long long n, int L) {
  const int j = (blockIdx.x * kPackThreads + threadIdx.x) * kPackWords;
  if (j >= L) return;
  float v[32][kPackWords];
  const bool vec = ((uintptr_t)x & 7) == 0;
  if (vec && 31LL * L + j + kPackWords <= n) {   // every row a whole vector
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const float2 f =
          __ldg(reinterpret_cast<const float2*>(x + (long long)k * L + j));
      v[k][0] = f.x, v[k][1] = f.y;
    }
  } else {   // rows that reach n, or x off 8 bytes: row by row, masked
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const long long e = (long long)k * L + j;
      if (vec && e + kPackWords <= n) {
        const float2 f = __ldg(reinterpret_cast<const float2*>(x + e));
        v[k][0] = f.x, v[k][1] = f.y;
      } else {
        v[k][0] = e < n ? __ldg(x + e) : 0.f;
        v[k][1] = e + 1 < n ? __ldg(x + e + 1) : 0.f;
      }
    }
  }
  uint32_t w[kPackWords] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < 32; ++k)
#pragma unroll
    for (int c = 0; c < kPackWords; ++c)
      w[c] |= (uint32_t)(v[k][c] >= 0.f) << k;
  *reinterpret_cast<uint2*>(words + j) = make_uint2(w[0], w[1]);
}

// the two words of a row at p (one 8-byte vector when aligned; the
// second 0 when `two` is false, at an odd L's last column)
__device__ __forceinline__ void load_pair(const uint32_t* p, bool vec,
                                          bool two, uint32_t (&w)[2]) {
  if (vec) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
    return;
  }
  w[0] = __ldg(p), w[1] = two ? __ldg(p + 1) : 0u;
}

// Payload r's terms into a thread's 8 x 2 sums: acc[k][c] += bit (k0 + k)
// of w[c] ? s_r : -s_r, from ws = w >> k0 and ns = the bits of -s_r. Setting
// the sign bit of -s_r where the bit is set gives s_r (for a NaN s_r, a NaN
// whose sign bit may differ; the add returns the card's one NaN either
// way): a shift, a LOP3 and the add a term.
__device__ __forceinline__ void add_terms(float (&acc)[kRowsPerThread][2],
                                          const uint32_t (&ws)[2],
                                          uint32_t ns) {
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      acc[k][c] = __fadd_rn(
          acc[k][c],
          __uint_as_float(ns ^ ((ws[c] << (31 - k)) & 0x80000000u)));
}

// payloads r0 .. r0 + kLoadBatch - 1 (those < K; kFull: all, loaded as
// 8-byte vectors with no guard) into a thread's sums (see
// unpack_sum_body)
template <bool kGrid, bool kFull>
__device__ __forceinline__ void unpack_batch(
    float (&acc)[kRowsPerThread][2], const uint32_t* __restrict__ words,
    const float* __restrict__ scales, const float* sc, int r0, int K, int L,
    int j, int k0, bool vec, bool two) {
  uint32_t w[kLoadBatch][2];
  float s[kLoadBatch];
#pragma unroll
  for (int t = 0; t < kLoadBatch; ++t) {
    if (kFull || r0 + t < K) {
      const uint32_t* p = words + (long long)(r0 + t) * L + j;
      if constexpr (kFull) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
        w[t][0] = v.x, w[t][1] = v.y;
      } else {
        load_pair(p, vec, two, w[t]);
      }
      if constexpr (kGrid) s[t] = __ldg(scales + r0 + t);
    }
  }
#pragma unroll
  for (int t = 0; t < kLoadBatch; ++t) {
    w[t][0] >>= k0;
    w[t][1] >>= k0;
  }
  if constexpr (kGrid) {
#pragma unroll
    for (int h = 0; h < kLoadBatch; h += kGridRows) {
      if (kFull || r0 + h < K) {
        float part[kRowsPerThread][2];
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k)
          part[k][0] = part[k][1] = 0.f;
#pragma unroll
        for (int t = h; t < h + kGridRows; ++t)
          if (kFull || r0 + t < K)
            add_terms(part, w[t], __float_as_uint(s[t]) ^ 0x80000000u);
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            acc[k][c] = __fadd_rn(acc[k][c], part[k][c]);
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < kLoadBatch; ++t)
      if (kFull || r0 + t < K)
        add_terms(acc, w[t], __float_as_uint(sc[r0 + t]) ^ 0x80000000u);
  }
}

// One thread's share of both unpack-sums: 2 adjacent word columns j, j + 1
// and bit rows k0 .. k0 + 7 (the layout above). kGrid false: payloads
// r = 0..K-1 fold into the sums in order from 0.0, the scales from `sc`
// (shared memory). kGrid true: the reference grid kernel's order. Rows
// 8b .. 8b + 7 fold into a partial from 0.0, and the output is partial 0,
// then + partial b in order b = 1..B-1; the scales come in beside the
// words, as loads whose address a warp shares. A fold from +0.0 never
// gives -0.0 under round-to-nearest, so 0.0 + partial 0 is partial 0 and
// the output folds the partials from 0.0 too. The reference pads K to a
// multiple of 8 with rows of scale 0 and bit 0: each adds -0.0, which
// leaves every float unchanged under round-to-nearest (+0 + -0 = +0,
// -0 + -0 = -0, a NaN stays a NaN), so rows r >= K are skipped, with no
// copy. A batch of kLoadBatch payloads is two whole row blocks.
template <bool kGrid>
__device__ __forceinline__ void unpack_sum_body(
    const uint32_t* __restrict__ words, const float* __restrict__ scales,
    const float* sc, float* __restrict__ out, int K, int L, long long n) {
  static_assert(kLoadBatch % kGridRows == 0, "a batch holds whole blocks");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = (warp % kRowGroups) * kRowsPerThread;
  const int j = ((blockIdx.x * kStrips + warp / kRowGroups) * 32 + lane) * 2;
  const long long e0 = (long long)k0 * L + j;
  if (j >= L || e0 >= n) return;        // no element of this thread < n
  // an even L starts every row 8-byte aligned; an odd L's last column
  // has no second column
  const bool even = (L & 1) == 0;
  const bool vec = even && ((uintptr_t)words & 7) == 0;
  const bool two = j + 1 < L;
  float acc[kRowsPerThread][2];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) acc[k][0] = acc[k][1] = 0.f;
  // the word pairs (and, kGrid, scales) of kLoadBatch payloads in flight
  // at once, then their adds. The grid kernel takes a whole batch of
  // aligned pairs on a path with no guard and no branch (on an H100: K =
  // 256 in 0.045 ms against 0.060 guarded); for K <= 32 that path was
  // slower at K = 32 (0.0141 ms against 0.0126), so it keeps the guards.
  for (int r0 = 0; r0 < K; r0 += kLoadBatch) {
    if (kGrid && vec && r0 + kLoadBatch <= K)
      unpack_batch<kGrid, true>(acc, words, scales, sc, r0, K, L, j, k0, vec,
                                two);
    else
      unpack_batch<kGrid, false>(acc, words, scales, sc, r0, K, L, j, k0,
                                 vec, two);
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const long long e = e0 + (long long)k * L;
    if (even && e + 1 < n) {
      *reinterpret_cast<float2*>(out + e) = make_float2(acc[k][0], acc[k][1]);
    } else {
      if (e < n) out[e] = acc[k][0];
      if (two && e + 1 < n) out[e + 1] = acc[k][1];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
unpack_sum_kernel(const uint32_t* __restrict__ words,
                  const float* __restrict__ scales, float* __restrict__ out,
                  int K, int L, long long n) {
  __shared__ float sc[kUnrollK];
  if ((int)threadIdx.x < K) sc[threadIdx.x] = scales[threadIdx.x];
  __syncthreads();
  unpack_sum_body<false>(words, scales, sc, out, K, L, n);
}

__global__ void __launch_bounds__(kThreads)
unpack_sum_grid_kernel(const uint32_t* __restrict__ words,
                       const float* __restrict__ scales,
                       float* __restrict__ out, int K, int L, long long n) {
  unpack_sum_body<true>(words, scales, nullptr, out, K, L, n);
}

}  // namespace

// x: n f32 on the card, any 4-byte aligned start; words: L =
// packed_words(n) 32-bit words (a multiple of 128), 8-byte aligned.
// Returns a cudaError_t (0 = success).
extern "C" int bps_onebit_pack(const void* x, void* words, long long n, int L,
                               void* stream) {
  if (L == 0) return 0;
  if (L % kPackWords != 0 || ((uintptr_t)words & 7) != 0)
    return (int)cudaErrorInvalidValue;
  const int per_block = kPackThreads * kPackWords;   // word columns
  pack_kernel<<<(L + per_block - 1) / per_block, kPackThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint32_t*>(words), n, L);
  return (int)cudaGetLastError();
}

// words: (K, L) 32-bit words; scales: K f32 on the card; out: n f32, the
// first n elements of the (32, L) sum. Returns a cudaError_t.
// 0 <= K <= 32.
extern "C" int bps_onebit_unpack_sum(const void* words, const void* scales,
                                     void* out, int K, int L, long long n,
                                     void* stream) {
  if (K < 0 || K > kUnrollK) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int per_block = kStrips * 64;   // word columns a block
  unpack_sum_kernel<<<(L + per_block - 1) / per_block, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(scales),
      static_cast<float*>(out), K, L, n);
  return (int)cudaGetLastError();
}

// The same contract for K > 32 payloads, in the grid kernel's order.
extern "C" int bps_onebit_unpack_sum_grid(const void* words,
                                          const void* scales, void* out,
                                          int K, int L, long long n,
                                          void* stream) {
  if (K < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int per_block = kStrips * 64;   // word columns a block
  unpack_sum_grid_kernel<<<(L + per_block - 1) / per_block, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(scales),
      static_cast<float*>(out), K, L, n);
  return (int)cudaGetLastError();
}

extern "C" const char* bps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
