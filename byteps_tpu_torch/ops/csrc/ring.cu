// Ring collective kernels for Hopper (sm_90a): the rotation (collect and
// gather, every leaf of a payload in one call) and the serial presum chain,
// with the CUDA IPC helpers that map the ranks' workspaces into each other.
//
// Replaces byteps_tpu/ops/ring_collective_kernels.py:_rotate_kernel (via
// _rotate_pallas: ring_collect, ring_allgather) and :_presum_kernel (via
// _presum_pallas: ring_presum). The TPU kernels address peers by logical
// device id with make_async_remote_copy and wait on DMA semaphores, which
// the DMA engine owns. Here every rank is a process that owns one
// workspace (cudaMalloc'd, zeroed) of
//
//   flags     uint32 [2][n]        at offset 0, one a (parity, source)
//   counters  uint32 [n]           at 4 * 2n (last-block counts, one a hop)
//   slots     bytes  [2][n][cap]   at slots_off
//
// and holds the base pointers of all n workspaces (its own and its peers',
// opened with cudaIpcOpenMemHandle) in a device table. A kernel writes a
// peer's landing slot with plain stores; the last of its blocks to finish
// raises the peer's flag with a release store at system scope after
// __threadfence_system(). The same code runs over NVLink when the ranks
// sit on different cards of a host.
//
// Two protocols, which differ only in who waits for a rank's own flags:
//   stream  no kernel waits on a peer: the stream does, with
//           cuStreamWaitValue32 (EQ, the call's epoch), between a kernel
//           that pushes and one that lands what arrived (ld.global.cg,
//           past L1). While a wait is pending the context has no work on
//           an SM, so a card that time-slices the ranks' contexts can run
//           the peer at once;
//   spin    one kernel pushes, then thread 0 of each block spins on the
//           flags (ld.acquire.sys) and the block lands.
// Which peer layout takes which (the wrapper's plan): a peer on this card
// in another process (the port's train_ring) takes stream: spinning there
// holds the time-sliced card for the rest of a slice (2.41 ms a call on an
// H100) where a switch to the peer costs about 0.15 ms. Peers whose
// contexts run at once with this one (in this process, or on other cards)
// take spin: there the stream form's second launch and wait cost more
// than a launch (in-process at n = 2, 0.024 ms a collect against 0.019;
// four cards, 0.104 against 0.063 back to back; PERF.md rows 12-13).
//
// rotate (one call per direction for every leaf of a payload; gather =
// ring_allgather, else ring_collect). The leaves sit in a landing slot at
// 16-byte-aligned offsets (the wrapper's slot_layout, a function of the
// leaves' shapes and dtypes, so every rank derives the same). The grid
// cuts the slot's span into ranges, one a block; 16-byte moves where both
// pointers allow, a byte tail otherwise (a 4-byte onebit scale and an odd
// uint8 row move too).
//   1. push: for t = 1 .. n-1, dest = (my + t) mod n, block b copies its
//      range of every leaf's row bound for dest (row dest of x for
//      collect, x itself for gather) into dest's slot for my; the last
//      block raises dest's flag (parity, my) for every dest. Then each
//      block copies its range of the own rows into out locally.
//   2. wait, for each source s, until the own flag (parity, s) holds the
//      epoch;
//   3. land: every source's slot into its rows of each leaf's out:
//      all_to_all (collect) or all_gather (gather) semantics, exact, as
//      the hops move bits only.
// stream: push_kernel, the stream's n-1 waits, land_kernel. spin:
// rotate_spin_kernel, the three steps in one.
//
// presum (f32, one leaf): hop 0 stores own row (my-1) mod n into the
// right neighbour's slot 1 and raises that flag; for t = 1 .. n-1, after
// the wait for its own flag t, hop t computes acc = __fadd_rn(slot t, own
// row (my-1-t) mod n) and, if t < n-1, stores acc into the right slot t+1
// and raises that flag, else into out. acc ends as segment my's sum in the
// chain order of _presum_jnp, p_{d+1} + p_{d+2} + ... + p_d, bit for bit.
// Each hop has a slot, a flag and a counter of its own (the TPU kernel's
// flow-control note: an upstream rank may run up to n-1 hops ahead).
// stream: n kernels, one a hop, and n-1 stream waits; spin: one kernel.
//
// The last block. Each block, after its stores to the peers, fences them
// to system scope and takes a ticket with atomicInc on the step's counter,
// which wraps to 0 at the grid's size: the block that draws gridDim.x - 1
// is last, and the counter is 0 again for the next kernel of the stream.
// That block fences once more (the others' stores, seen through their
// fences and the counter, come before its flag) and releases the flags.
//
// Flags and slot reuse. The host keeps one epoch counter per workspace and
// passes it to each call; all ranks call the same collectives in the same
// order, so their epochs agree. A flag takes the epoch's value, so nothing
// is ever reset; slots and flags are double-buffered on the epoch's parity
// and both collectives share them. Rank r writes a slot of parity p in
// call e, and next in call e+2. Step by step, for any peer d:
//   a. r's writes of call e+2 come, in r's stream order, after r's waits
//      of call e+1;
//   b. those waits need, directly (rotate: a flag from every peer) or
//      through the chain (presum: r's last hop carries every other rank's
//      hop of call e+1), d's push of call e+1;
//   c. d made that push, in its own stream order, after all of its call e:
//      the lands and hops that read d's slots of parity p, and the waits
//      that read its flags of parity p.
// So r's writes and flags of call e+2 land after d has read everything of
// call e, and a flag never skips a value its owner still waits for. The
// argument holds for either protocol (spin: the waits are inside the
// kernel, before its lands). A call with an empty payload launches nothing
// and takes no epoch.
//
// One process's streams may share a hardware queue, where a stream's wait
// holds back whatever follows it in the queue. A rank process calls on
// one stream, so that costs nothing there; peers in one process that take
// the stream form (the in-process measurements) issue a call step by step
// across the ranks, every wait after the push or hop it needs (LocalPeers
// in the wrapper).
//
// Waits fail loudly: neither a stream wait nor a spin has a timeout, so
// the host records an event after each call and raises from the
// workspace's next check when one is still pending past its bound, naming
// the epoch and the flags that do not hold it (read through a stream of
// their own). If the driver has no stream memory operations, the
// workspace refuses to start.
//
// What bounds them: latency, not bytes. A 64 KB onebit row moves in about
// 40 ns of HBM time, while each hop costs a flag's trip through L2, a
// launch and the stream's wait and, with two processes on one card, a
// switch of the card's time-slicing each way.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 64;
constexpr int kMaxLeaves = 8;
constexpr long long kBlockBytes = 16384;   // a block's range before the cap
// a driver (CUresult) error is returned as kDriverError + its code
constexpr int kDriverError = 100000;

// Every leaf of a payload: its source rows, its out (n rows), a row's
// bytes and the row's offset in a landing slot.
struct Leaves {
  const char* src[kMaxLeaves];
  char* out[kMaxLeaves];
  long long bytes[kMaxLeaves];
  long long off[kMaxLeaves];
  int count;
};

__device__ __forceinline__ void st_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned* flag_at(char* ws, int n, int p, int i) {
  return reinterpret_cast<unsigned*>(ws) + p * n + i;
}

__device__ __forceinline__ unsigned* counter_at(char* ws, int n, int t) {
  return reinterpret_cast<unsigned*>(ws) + 2 * n + t;
}

__device__ __forceinline__ char* slot_at(char* ws, long long slots_off,
                                         long long cap, int n, int p,
                                         int i) {
  return ws + slots_off + (long long)(p * n + i) * cap;
}

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The spinning form's wait: the whole block waits until thread 0 sees
// *flag == epoch (no bound: the host's watch reports a wait that lasts).
__device__ __forceinline__ void spin_until(const unsigned* flag,
                                           unsigned epoch) {
  if (threadIdx.x == 0)
    while (ld_acquire_sys(flag) != epoch) __nanosleep(100);
  __syncthreads();
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

// Called by every thread after the block's stores to its peers: true in
// thread 0 of the last block of the grid to get here (see the header).
__device__ __forceinline__ bool last_block(unsigned* counter) {
  __syncthreads();
  if (threadIdx.x != 0) return false;
  __threadfence_system();
  if (atomicInc(counter, gridDim.x - 1) != gridDim.x - 1) return false;
  __threadfence_system();
  return true;
}

// The part [a, b) of leaf l that falls in the block's range [lo, hi) of the
// slot span; false if none.
__device__ __forceinline__ bool overlap(const Leaves& lv, int l, long long lo,
                                       long long hi, long long* a,
                                       long long* b) {
  *a = max(lo, lv.off[l]);
  *b = min(hi, lv.off[l] + lv.bytes[l]);
  return *a < *b;
}

// The rotate's steps, each over the block's range [lo, hi) of the span.
struct Rotate {
  Leaves lv;
  long long span, per_block;
  int n, my, gather;
  unsigned epoch;
  const unsigned long long* peers;
  long long slots_off, cap;

  __device__ long long lo() const { return (long long)blockIdx.x * per_block; }
  __device__ long long hi() const { return min(lo() + per_block, span); }
  __device__ char* ws(int r) const {
    return reinterpret_cast<char*>(peers[r]);
  }
  __device__ const char* row(int l, int r) const {
    return gather ? lv.src[l] : lv.src[l] + r * lv.bytes[l];
  }

  // Every leaf's row bound for each dest into dest's slot for my; the last
  // block raises dest's flag (parity, my) for every dest; then the own rows
  // into out, locally.
  __device__ void push() const {
    const int p = epoch & 1;
    long long a, b;
    for (int t = 1; t < n; ++t) {
      const int dest = (my + t) % n;
      char* const slot = slot_at(ws(dest), slots_off, cap, n, p, my);
      for (int l = 0; l < lv.count; ++l)
        if (overlap(lv, l, lo(), hi(), &a, &b))
          block_copy<false>(slot + a, row(l, dest) + (a - lv.off[l]), b - a);
    }
    if (last_block(counter_at(ws(my), n, 0)))
      for (int t = 1; t < n; ++t)
        st_release_sys(flag_at(ws((my + t) % n), n, p, my), epoch);
    for (int l = 0; l < lv.count; ++l)
      if (overlap(lv, l, lo(), hi(), &a, &b))
        block_copy<false>(lv.out[l] + my * lv.bytes[l] + (a - lv.off[l]),
                          row(l, my) + (a - lv.off[l]), b - a);
  }

  // Every source's slot into its rows of each leaf's out.
  __device__ void land() const {
    const int p = epoch & 1;
    long long a, b;
    for (int t = 1; t < n; ++t) {
      const int s = (my - t + n) % n;
      const char* slot = slot_at(ws(my), slots_off, cap, n, p, s);
      for (int l = 0; l < lv.count; ++l)
        if (overlap(lv, l, lo(), hi(), &a, &b))
          block_copy<true>(lv.out[l] + s * lv.bytes[l] + (a - lv.off[l]),
                           slot + a, b - a);
    }
  }
};

__global__ void __launch_bounds__(kThreads) push_kernel(const Rotate r) {
  r.push();
}

__global__ void __launch_bounds__(kThreads) land_kernel(const Rotate r) {
  r.land();
}

// The spinning form: push, every block waits for each source's flag, land.
__global__ void __launch_bounds__(kThreads) rotate_spin_kernel(
    const Rotate r) {
  r.push();
  for (int t = 1; t < r.n; ++t)
    spin_until(flag_at(r.ws(r.my), r.n, r.epoch & 1, (r.my - t + r.n) % r.n),
               r.epoch);
  r.land();
}

// Hops t0 .. t1-1 of the presum chain (see the header): one hop a kernel
// in the stream-wait form, every hop in one kernel (kSpin, each block
// waiting for its own flag t before hop t) in the spinning form. Every
// loop maps element i (or float4 i) to the same thread.
template <bool kSpin>
__global__ void __launch_bounds__(kThreads)
presum_kernel(const float* __restrict__ src, float* __restrict__ out,
              long long row, long long per_block, int n, int my, int vec,
              int t0, int t1, unsigned epoch,
              const unsigned long long* __restrict__ peers,
              long long slots_off, long long cap) {
  const long long lo = (long long)blockIdx.x * per_block;
  const long long len = min(per_block, row - lo);
  const int p = epoch & 1;
  char* const mine = reinterpret_cast<char*>(peers[my]);
  char* const right = reinterpret_cast<char*>(peers[(my + 1) % n]);
  for (int t = t0; t < t1; ++t) {
    if (kSpin && t > 0) spin_until(flag_at(mine, n, p, t), epoch);
    const float* own =
        src + (long long)(((my - 1 - t) % n + n) % n) * row + lo;
    const float* land =
        reinterpret_cast<const float*>(slot_at(mine, slots_off, cap, n, p,
                                               t)) + lo;
    float* dst = t < n - 1
                     ? reinterpret_cast<float*>(
                           slot_at(right, slots_off, cap, n, p, t + 1)) + lo
                     : out + lo;
    if (vec) {                                   // len % 4 == 0
      const float4* o4 = reinterpret_cast<const float4*>(own);
      const float4* r4 = reinterpret_cast<const float4*>(land);
      float4* d4 = reinterpret_cast<float4*>(dst);
      for (long long i = threadIdx.x; i < len >> 2; i += kThreads) {
        float4 v = o4[i];
        if (t) {
          const float4 r = __ldcg(r4 + i);
          v = make_float4(__fadd_rn(r.x, v.x), __fadd_rn(r.y, v.y),
                          __fadd_rn(r.z, v.z), __fadd_rn(r.w, v.w));
        }
        d4[i] = v;
      }
    } else {
      for (long long i = threadIdx.x; i < len; i += kThreads)
        dst[i] = t ? __fadd_rn(__ldcg(land + i), own[i]) : own[i];
    }
    if (t < n - 1 && last_block(counter_at(mine, n, t)))
      st_release_sys(flag_at(right, n, p, t + 1), epoch);
  }
}

// Blocks for a span of `units` (bytes or f32), each range a multiple of
// `align` units; every rank derives the same grid from the same span.
void split(long long units, long long per_unit_bytes, long long align,
           long long* blocks, long long* per) {
  if (units <= 0) {                           // an empty push: one block
    *blocks = 1;
    *per = 0;
    return;
  }
  long long nb = (units * per_unit_bytes + kBlockBytes - 1) / kBlockBytes;
  nb = nb < 1 ? 1 : (nb > kMaxBlocks ? kMaxBlocks : nb);
  long long pb = (units + nb - 1) / nb;
  pb = (pb + align - 1) / align * align;
  *per = pb;
  *blocks = (units + pb - 1) / pb;
}

// The driver's entry points through the runtime, so the library needs no
// -lcuda.
void* driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
  if (cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault,
                                       &q) != cudaSuccess ||
      q != cudaDriverEntryPointSuccess)
    return nullptr;
  return p;
}

typedef CUresult (*WaitValue32)(CUstream, CUdeviceptr, cuuint32_t,
                                unsigned int);

WaitValue32 wait_value32() {
  static WaitValue32 fn =
      reinterpret_cast<WaitValue32>(driver_entry("cuStreamWaitValue32"));
  return fn;
}

// (count, desc) -> Leaves; desc holds count rows of (src, out, bytes, off).
// Returns the slot span (the last leaf's end), or -1 if count is too big.
long long unpack(int count, const long long* desc, Leaves* lv) {
  if (count < 0 || count > kMaxLeaves) return -1;
  memset(lv, 0, sizeof *lv);
  lv->count = count;
  long long span = 0;
  for (int l = 0; l < count; ++l) {
    lv->src[l] = reinterpret_cast<const char*>(desc[4 * l]);
    lv->out[l] = reinterpret_cast<char*>(desc[4 * l + 1]);
    lv->bytes[l] = desc[4 * l + 2];
    lv->off[l] = desc[4 * l + 3];
    span = lv->off[l] + lv->bytes[l] > span ? lv->off[l] + lv->bytes[l]
                                            : span;
  }
  return span;
}

}  // namespace

extern "C" int bps_ring_max_leaves() { return kMaxLeaves; }

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

// The stream waits until *word == value (word: device memory). flush adds
// CU_STREAM_WAIT_VALUE_FLUSH.
extern "C" int bps_ring_wait(void* stream, const void* word, unsigned value,
                             int flush) {
  const WaitValue32 fn = wait_value32();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const CUresult r = fn(static_cast<CUstream>(stream),
                        reinterpret_cast<CUdeviceptr>(word), value,
                        CU_STREAM_WAIT_VALUE_EQ |
                            (flush ? CU_STREAM_WAIT_VALUE_FLUSH : 0));
  return r == CUDA_SUCCESS ? 0 : kDriverError + (int)r;
}

// Whether stream memory operations work here: a wait on `word`, which
// holds 0, on `stream`, synchronised; can_flush tells whether the device
// supports CU_STREAM_WAIT_VALUE_FLUSH.
extern "C" int bps_ring_init(const void* word, void* stream, int* can_flush) {
  int rc = bps_ring_wait(stream, word, 0, 0);
  if (rc != 0) return rc;
  const cudaError_t e = cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  typedef CUresult (*Attr)(int*, CUdevice_attribute, CUdevice);
  const Attr attr = reinterpret_cast<Attr>(driver_entry("cuDeviceGetAttribute"));
  int dev = 0, v = 0;
  if (attr != nullptr && cudaGetDevice(&dev) == cudaSuccess &&
      attr(&v, CU_DEVICE_ATTRIBUTE_CAN_FLUSH_REMOTE_WRITES, dev) != CUDA_SUCCESS)
    v = 0;
  *can_flush = v;
  return 0;
}

// Copy bytes of device memory to the host through a stream of the
// library's own, which does not wait for any other stream (a call's wait
// may be pending on the caller's).
extern "C" int bps_ring_read(void* host, const void* dev, long long bytes) {
  static cudaStream_t side = [] {
    cudaStream_t s = nullptr;
    cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
    return s;
  }();
  if (side == nullptr) return (int)cudaErrorNotReady;
  cudaError_t e = cudaMemcpyAsync(host, dev, (size_t)bytes,
                                  cudaMemcpyDeviceToHost, side);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamSynchronize(side);
}

namespace {

// A rotate's launch parameters from the host's arguments; false if there
// are too many leaves.
bool make_rotate(int count, const long long* desc, int n, int my,
                 int gather, unsigned epoch, const void* peers,
                 long long slots_off, long long cap, Rotate* r,
                 long long* blocks) {
  r->span = unpack(count, desc, &r->lv);
  if (r->span < 0) return false;
  split(r->span, 1, 16, blocks, &r->per_block);
  r->n = n;
  r->my = my;
  r->gather = gather;
  r->epoch = epoch;
  r->peers = static_cast<const unsigned long long*>(peers);
  r->slots_off = slots_off;
  r->cap = cap;
  return true;
}

// The presum grid and whether its rows take float4 moves.
void presum_grid(const void* src, const void* out, long long row,
                 long long* blocks, long long* per, int* vec) {
  split(row, 4, 4, blocks, per);
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(out);
  *vec = (a & 15) == 0 && row % 4 == 0;
}

}  // namespace

// Step 1 of a stream-wait rotate call alone (also an empty push: count 0
// raises the flags and moves nothing).
extern "C" int bps_ring_push(int count, const long long* desc, int n, int my,
                             int gather, unsigned epoch, const void* peers,
                             long long slots_off, long long cap,
                             void* stream) {
  Rotate r;
  long long blocks;
  if (!make_rotate(count, desc, n, my, gather, epoch, peers, slots_off, cap,
                   &r, &blocks))
    return (int)cudaErrorInvalidValue;
  push_kernel<<<(unsigned)blocks, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(r);
  return (int)cudaGetLastError();
}

// Step 3 of a stream-wait rotate call alone.
extern "C" int bps_ring_land(int count, const long long* desc, int n, int my,
                             unsigned epoch, const void* peers,
                             long long slots_off, long long cap,
                             void* stream) {
  Rotate r;
  long long blocks;
  if (!make_rotate(count, desc, n, my, 0, epoch, peers, slots_off, cap, &r,
                   &blocks))
    return (int)cudaErrorInvalidValue;
  land_kernel<<<(unsigned)blocks, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(r);
  return (int)cudaGetLastError();
}

// A whole rotate call. desc: count rows of (src, out, row bytes, slot
// offset); src (n, row) collect or (row) gather, out (n, row); mine: this
// rank's workspace base. spin: one spinning kernel; else push, the
// stream's waits on this rank's flags, land.
extern "C" int bps_ring_rotate(int count, const long long* desc, int n,
                               int my, int gather, unsigned epoch, int spin,
                               const void* peers, const void* mine,
                               long long slots_off, long long cap,
                               void* stream) {
  Rotate r;
  long long blocks;
  if (!make_rotate(count, desc, n, my, gather, epoch, peers, slots_off, cap,
                   &r, &blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (spin) {
    rotate_spin_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(r);
    return (int)cudaGetLastError();
  }
  push_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(r);
  int rc = (int)cudaGetLastError();
  const int p = epoch & 1;
  for (int t = 1; t < n && rc == 0; ++t)
    rc = bps_ring_wait(stream, static_cast<const unsigned*>(mine) + p * n
                                   + (my - t + n) % n,
                       epoch, 0);
  if (rc != 0) return rc;
  land_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(r);
  return (int)cudaGetLastError();
}

// Hop t of a stream-wait presum call alone. src: (n, row) f32; out: (row)
// f32.
extern "C" int bps_ring_presum_hop(const void* src, void* out, long long row,
                                   int n, int my, int t, unsigned epoch,
                                   const void* peers, long long slots_off,
                                   long long cap, void* stream) {
  if (row <= 0) return 0;
  long long blocks, per;
  int vec;
  presum_grid(src, out, row, &blocks, &per, &vec);
  presum_kernel<false><<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(out), row, per, n,
      my, vec, t, t + 1, epoch, static_cast<const unsigned long long*>(peers),
      slots_off, cap);
  return (int)cudaGetLastError();
}

// A whole presum call: spin, one spinning kernel; else n kernels and n-1
// stream waits.
extern "C" int bps_ring_presum(const void* src, void* out, long long row,
                               int n, int my, unsigned epoch, int spin,
                               const void* peers, const void* mine,
                               long long slots_off, long long cap,
                               void* stream) {
  if (row <= 0) return 0;
  if (spin) {
    long long blocks, per;
    int vec;
    presum_grid(src, out, row, &blocks, &per, &vec);
    presum_kernel<true><<<(unsigned)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(src), static_cast<float*>(out), row, per,
        n, my, vec, 0, n, epoch,
        static_cast<const unsigned long long*>(peers), slots_off, cap);
    return (int)cudaGetLastError();
  }
  const int p = epoch & 1;
  for (int t = 0; t < n; ++t) {
    int rc = t == 0 ? 0
                    : bps_ring_wait(stream, static_cast<const unsigned*>(mine)
                                                + p * n + t,
                                    epoch, 0);
    if (rc == 0)
      rc = bps_ring_presum_hop(src, out, row, n, my, t, epoch, peers,
                               slots_off, cap, stream);
    if (rc != 0) return rc;
  }
  return 0;
}

extern "C" const char* bps_error_string(int code) {
  if (code >= kDriverError) {
    typedef CUresult (*ErrStr)(CUresult, const char**);
    static const ErrStr fn =
        reinterpret_cast<ErrStr>(driver_entry("cuGetErrorString"));
    const char* s = nullptr;
    if (fn == nullptr ||
        fn(static_cast<CUresult>(code - kDriverError), &s) != CUDA_SUCCESS ||
        s == nullptr)
      return "unknown driver error";
    return s;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
