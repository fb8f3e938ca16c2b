// Ring collective kernels for Hopper (sm_90a): the rotation (collect and
// gather) and the serial presum chain, with the CUDA IPC helpers that map
// the ranks' workspaces into each other.
//
// Replaces byteps_tpu/ops/ring_collective_kernels.py:_rotate_kernel (via
// _rotate_pallas: ring_collect, ring_allgather) and :_presum_kernel (via
// _presum_pallas: ring_presum). The TPU kernels address peers by logical
// device id with make_async_remote_copy and DMA semaphores. Here every
// rank is a process that owns one workspace (cudaMalloc'd, zeroed) of
//
//   flags  uint32 [2][n][kMaxBlocks]      at offset 0
//   slots  bytes  [2][n][cap]             at slots_off
//
// and holds the base pointers of all n workspaces (its own and its peers',
// opened with cudaIpcOpenMemHandle) in a device table. A kernel writes a
// peer's landing slot with plain stores and raises the peer's flag with a
// release store at system scope after __threadfence_system(); the peer's
// thread 0 polls its own flag with ld.acquire.sys and its block reads the
// slot past L1 (ld.global.cg). The same code runs over NVLink when the
// ranks sit on different cards of one host.
//
// rotate (one launch per rank and call; gather = ring_allgather, else
// ring_collect): the grid cuts the row's bytes into ranges, one a block,
// 16-byte moves where both pointers allow and a byte tail otherwise (so a
// 4-byte onebit scale and an odd uint8 row move too). For t = 1 .. n-1,
// dest = (my + t) mod n, block b copies its range of the source row (row
// dest of x for collect, x itself for gather) into dest's slot for worker
// my, then raises dest's flag (my, b). It copies its own row locally and
// then, for each source s, waits for flag (s, b) and copies slot s into
// output row s: all_to_all (collect) or all_gather (gather) semantics,
// exact, as the hops move bits only.
//
// presum (f32): block b owns an element range. acc = own row (my-1) mod n;
// for t = 1 .. n-1 it stores acc into the right neighbour's slot t, raises
// that flag, waits for its own hop-t flag and sets acc = slot t + own row
// (my-1-t) mod n. acc ends as segment my's sum in the chain order of
// _presum_jnp, p_{d+1} + p_{d+2} + ... + p_d, bit for bit. Each hop has a
// slot and a flag of its own (the TPU kernel's flow-control note: an
// upstream rank may run up to n-1 hops ahead).
//
// Flags and slot reuse. The host keeps one epoch counter per workspace and
// passes it to each launch; all ranks call the same collectives in the
// same order, so their epochs agree. A flag takes the epoch's value, so
// nothing is ever reset; slots and flags are double-buffered on the
// epoch's parity, and both kernels share them. Reuse is safe: a rank
// cannot finish call e+1 until each peer has started call e+1 (rotate
// waits on every peer; presum's result on rank d chains through every
// other rank, its right neighbour first), and a peer starts call e+1 only
// after its kernel of call e, which read the slots of parity e, has
// finished (stream order). So the writes of call e+2 land after every
// read of call e. A call with an empty row launches nothing and takes no
// epoch.
//
// Waits fail loudly: a wait past kWaitNs of %globaltimer writes what it
// waited for into the error words (pinned host memory, readable after the
// context is lost) and traps; the next synchronisation raises.
//
// What bounds them: latency, not bytes. A 64 KB onebit row moves in about
// 40 ns of HBM time, while each hop costs a flag round trip through L2
// (and, with two processes on one card, a context switch of the card's
// time-slicing). Later levers: cp.async/TMA bulk copies, one launch for
// all payload leaves of a chunk, and NVLink peers on a multi-card host.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 64;             // flag columns per (parity, slot)
constexpr long long kBlockBytes = 16384;   // a block's range before the cap
constexpr unsigned long long kWaitNs = 30ull * 1000 * 1000 * 1000;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned* flag_at(char* ws, int n, int p,
                                             int slot, int b) {
  return reinterpret_cast<unsigned*>(ws) + ((long long)(p * n + slot))
         * kMaxBlocks + b;
}

__device__ __forceinline__ char* slot_at(char* ws, long long slots_off,
                                         long long cap, int n, int p,
                                         int slot) {
  return ws + slots_off + (long long)(p * n + slot) * cap;
}

// Thread 0 only: spin until *flag == epoch, or record and trap.
// err: [0] kind (1 rotate, 2 presum), [1] epoch, [2] slot, [3] block,
// [4] the value seen.
__device__ void wait_flag(const unsigned* flag, unsigned epoch,
                          volatile unsigned long long* err, int kind,
                          int slot) {
  if (ld_acquire_sys(flag) == epoch) return;
  const unsigned long long t0 = global_ns();
  unsigned seen;
  while ((seen = ld_acquire_sys(flag)) != epoch) {
    if (global_ns() - t0 > kWaitNs) {
      err[1] = epoch;
      err[2] = (unsigned long long)slot;
      err[3] = blockIdx.x;
      err[4] = seen;
      __threadfence_system();
      err[0] = (unsigned long long)kind;
      __threadfence_system();
      __trap();
    }
    __nanosleep(100);
  }
}

// The block copies nbytes from src to dst: 16-byte moves where both
// pointers are 16-aligned, 4-byte where 4-aligned, then a byte tail.
// kCg reads past L1 (landing slots written by another rank).
template <bool kCg>
__device__ void block_copy(char* dst, const char* src, long long nbytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst) |
                      reinterpret_cast<uintptr_t>(src);
  long long done = 0;
  if ((a & 15) == 0) {
    const long long m = nbytes >> 4;
    int4* d = reinterpret_cast<int4*>(dst);
    const int4* s = reinterpret_cast<const int4*>(src);
    for (long long i = threadIdx.x; i < m; i += kThreads)
      d[i] = kCg ? __ldcg(s + i) : s[i];
    done = m << 4;
  } else if ((a & 3) == 0) {
    const long long m = nbytes >> 2;
    int* d = reinterpret_cast<int*>(dst);
    const int* s = reinterpret_cast<const int*>(src);
    for (long long i = threadIdx.x; i < m; i += kThreads)
      d[i] = kCg ? __ldcg(s + i) : s[i];
    done = m << 2;
  }
  for (long long i = done + threadIdx.x; i < nbytes; i += kThreads)
    dst[i] = kCg ? __ldcg(src + i) : src[i];
}

// After the block's stores to a peer: fence them to system scope and
// raise the peer's flag.
__device__ __forceinline__ void raise_flag(unsigned* flag, unsigned epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    st_release_sys(flag, epoch);
  }
}

__global__ void __launch_bounds__(kThreads)
rotate_kernel(const char* __restrict__ src, char* __restrict__ out,
              long long row_bytes, long long per_block, int n, int my,
              int gather, unsigned epoch,
              const unsigned long long* __restrict__ peers,
              long long slots_off, long long cap,
              unsigned long long* err) {
  const int b = blockIdx.x;
  const long long lo = (long long)b * per_block;
  const long long len = min(per_block, row_bytes - lo);
  const int p = epoch & 1;
  char* const mine = reinterpret_cast<char*>(peers[my]);
  for (int t = 1; t < n; ++t) {
    const int dest = (my + t) % n;
    char* const ws = reinterpret_cast<char*>(peers[dest]);
    const char* s = (gather ? src : src + dest * row_bytes) + lo;
    block_copy<false>(slot_at(ws, slots_off, cap, n, p, my) + lo, s, len);
    raise_flag(flag_at(ws, n, p, my, b), epoch);
  }
  block_copy<false>(out + my * row_bytes + lo,
                    (gather ? src : src + my * row_bytes) + lo, len);
  for (int t = 1; t < n; ++t) {
    const int s = (my - t + n) % n;
    if (threadIdx.x == 0)
      wait_flag(flag_at(mine, n, p, s, b), epoch, err, 1, s);
    __syncthreads();
    block_copy<true>(out + s * row_bytes + lo,
                     slot_at(mine, slots_off, cap, n, p, s) + lo, len);
  }
}

// acc lives in out[lo, lo + len): every loop maps element i (or float4 i)
// to the same thread, so a thread reads back only what it wrote.
__global__ void __launch_bounds__(kThreads)
presum_kernel(const float* __restrict__ src, float* __restrict__ out,
              long long row, long long per_block, int n, int my, int vec,
              unsigned epoch, const unsigned long long* __restrict__ peers,
              long long slots_off, long long cap,
              unsigned long long* err) {
  const int b = blockIdx.x;
  const long long lo = (long long)b * per_block;
  const long long len = min(per_block, row - lo);
  const int p = epoch & 1;
  char* const mine = reinterpret_cast<char*>(peers[my]);
  char* const right = reinterpret_cast<char*>(peers[(my + 1) % n]);
  float* const acc = out + lo;
  const float* first = src + (long long)((my - 1 + n) % n) * row + lo;
  const long long m = vec ? len >> 2 : len;   // len % 4 == 0 when vec
  if (vec) {
    for (long long i = threadIdx.x; i < m; i += kThreads)
      reinterpret_cast<float4*>(acc)[i] =
          reinterpret_cast<const float4*>(first)[i];
  } else {
    for (long long i = threadIdx.x; i < m; i += kThreads) acc[i] = first[i];
  }
  for (int t = 1; t < n; ++t) {
    float* d = reinterpret_cast<float*>(
        slot_at(right, slots_off, cap, n, p, t)) + lo;
    if (vec) {
      for (long long i = threadIdx.x; i < m; i += kThreads)
        reinterpret_cast<float4*>(d)[i] = reinterpret_cast<float4*>(acc)[i];
    } else {
      for (long long i = threadIdx.x; i < m; i += kThreads) d[i] = acc[i];
    }
    raise_flag(flag_at(right, n, p, t, b), epoch);
    if (threadIdx.x == 0)
      wait_flag(flag_at(mine, n, p, t, b), epoch, err, 2, t);
    __syncthreads();
    const float* land = reinterpret_cast<const float*>(
        slot_at(mine, slots_off, cap, n, p, t)) + lo;
    const float* own =
        src + (long long)(((my - 1 - t) % n + n) % n) * row + lo;
    if (vec) {
      for (long long i = threadIdx.x; i < m; i += kThreads) {
        const float4 r = __ldcg(reinterpret_cast<const float4*>(land) + i);
        const float4 o = reinterpret_cast<const float4*>(own)[i];
        reinterpret_cast<float4*>(acc)[i] =
            make_float4(__fadd_rn(r.x, o.x), __fadd_rn(r.y, o.y),
                        __fadd_rn(r.z, o.z), __fadd_rn(r.w, o.w));
      }
    } else {
      for (long long i = threadIdx.x; i < m; i += kThreads)
        acc[i] = __fadd_rn(__ldcg(land + i), own[i]);
    }
  }
}

// Blocks for a row of `units` (bytes or f32), each range a multiple of
// `align` units; every rank derives the same grid from the same row.
void split(long long units, long long per_unit_bytes, long long align,
           long long* blocks, long long* per) {
  long long nb = (units * per_unit_bytes + kBlockBytes - 1) / kBlockBytes;
  nb = nb < 1 ? 1 : (nb > kMaxBlocks ? kMaxBlocks : nb);
  long long pb = (units + nb - 1) / nb;
  pb = (pb + align - 1) / align * align;
  *per = pb;
  *blocks = (units + pb - 1) / pb;
}

}  // namespace

extern "C" int bps_ring_max_blocks() { return kMaxBlocks; }

extern "C" int bps_ring_handle_size() {
  return (int)sizeof(cudaIpcMemHandle_t);
}

// A zeroed device buffer for flags and landing slots.
extern "C" int bps_ring_alloc(long long bytes, void** ptr) {
  cudaError_t e = cudaMalloc(ptr, (size_t)bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemset(*ptr, 0, (size_t)bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}

extern "C" int bps_ring_free(void* ptr) { return (int)cudaFree(ptr); }

extern "C" int bps_ring_get_handle(void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t e = cudaIpcGetMemHandle(&h, ptr);
  if (e == cudaSuccess) memcpy(handle, &h, sizeof h);
  return (int)e;
}

extern "C" int bps_ring_open_handle(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int bps_ring_close_handle(void* ptr) {
  return (int)cudaIpcCloseMemHandle(ptr);
}

// Zeroed pinned host words the kernels can write (the error record).
extern "C" int bps_ring_host_alloc(long long bytes, void** host,
                                   void** dev) {
  cudaError_t e = cudaHostAlloc(host, (size_t)bytes, cudaHostAllocMapped);
  if (e != cudaSuccess) return (int)e;
  memset(*host, 0, (size_t)bytes);
  return (int)cudaHostGetDevicePointer(dev, *host, 0);
}

extern "C" int bps_ring_host_free(void* host) {
  return (int)cudaFreeHost(host);
}

// src: (n, row_bytes) collect or (row_bytes) gather; out: (n, row_bytes);
// peers: n workspace base pointers on the card. Returns a cudaError_t.
extern "C" int bps_ring_rotate(const void* src, void* out, long long row_bytes,
                               int n, int my, int gather, unsigned epoch,
                               const void* peers, long long slots_off,
                               long long cap, void* err, void* stream) {
  if (row_bytes <= 0) return 0;
  long long blocks, per;
  split(row_bytes, 1, 16, &blocks, &per);
  rotate_kernel<<<(unsigned)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), static_cast<char*>(out), row_bytes, per,
      n, my, gather, epoch, static_cast<const unsigned long long*>(peers),
      slots_off, cap, static_cast<unsigned long long*>(err));
  return (int)cudaGetLastError();
}

// src: (n, row) f32; out: (row) f32. Returns a cudaError_t.
extern "C" int bps_ring_presum(const void* src, void* out, long long row,
                               int n, int my, unsigned epoch,
                               const void* peers, long long slots_off,
                               long long cap, void* err, void* stream) {
  if (row <= 0) return 0;
  long long blocks, per;
  split(row, 4, 4, &blocks, &per);
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(out);
  const int vec = (a & 15) == 0 && row % 4 == 0;
  presum_kernel<<<(unsigned)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(out), row, per, n,
      my, vec, epoch, static_cast<const unsigned long long*>(peers),
      slots_off, cap, static_cast<unsigned long long*>(err));
  return (int)cudaGetLastError();
}

extern "C" const char* bps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
