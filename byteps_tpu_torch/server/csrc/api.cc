// C API surface loaded from Python via ctypes (no pybind11 in this image).
// Reference analog: the extern "C" block of byteps/common/operations.h plus
// byteps/server's StartPS entry.
#include <cstdint>
#include <cstring>
#include <vector>

#include "client.h"
#include "codec.h"
#include "server.h"

extern "C" {

int bps_server_start(uint16_t port, int num_workers, int engine_threads,
                     int async_mode, int pull_timeout_ms, int server_id,
                     int enable_schedule, int lease_ms, int staleness) {
  return bps::StartServer(port, num_workers, engine_threads, async_mode != 0,
                          pull_timeout_ms, server_id, enable_schedule != 0,
                          lease_ms, staleness);
}

// Elastic-membership observability: the in-process server's epoch and
// live worker set (the IPC analog of the epoch every TCP response
// carries).
uint64_t bps_server_epoch() { return bps::ServerEpoch(); }

int bps_server_members(uint64_t* epoch, uint32_t* live_count,
                       uint8_t* bitmap, uint32_t cap) {
  return bps::ServerMembers(epoch, live_count, bitmap, cap);
}

// Mid-stream worker admission against the in-process server (the IPC
// analog of kJoin; scale-up elasticity). Returns the post-admission
// epoch, or negative (-1 out of range, -2 fixed membership, -10 no
// server in this process).
int64_t bps_server_join(int worker) {
  if (worker < 0 || worker > 0xFFFF) return -1;
  return bps::ServerJoin(static_cast<uint16_t>(worker));
}

void bps_server_wait() { bps::WaitServer(); }

void bps_server_stop() { bps::StopServer(); }

void bps_server_trace_enable(int on) { bps::ServerTraceEnable(on != 0); }

// e4m3 conversions exposed for the Python<->C++ bit-exactness tests
// (tests/test_dcn.py asserts parity with the ml_dtypes cast over all
// 256 byte values and random grids).
float bps_fp8_to_float(uint8_t b) { return bps::fp8_to_float(b); }

uint8_t bps_float_to_fp8(float f) { return bps::float_to_fp8(f); }

int bps_server_trace_dump(const char* path) {
  return bps::ServerTraceDump(path);
}

// ---- what-if simulator calibration (byteps_tpu/sim/extract.py) ------------
// Price the server's REAL codec paths — push-side decode_sum and the
// two-way re-encode — without a running server: the numpy wire codecs
// are not rate-representative of these loops (bit unpack, scatter-add,
// top-k reselection), and a what-if over a codec the recorded run never
// exercised needs the C++ rates its PUSH/PULL spans would carry.
int64_t bps_codec_decode_sum(uint8_t codec, const char* buf, int64_t len,
                             float* dst, int64_t n) {
  if (!bps::validate_payload(codec, buf, static_cast<size_t>(len), n))
    return -1;
  bps::decode_sum(codec, buf, static_cast<size_t>(len), dst, n);
  return 0;
}

int64_t bps_codec_encode(uint8_t codec, const float* src, int64_t n,
                         uint32_t topk_k, uint64_t seed, char* out,
                         int64_t cap) {
  bps::CodecHint hint;
  hint.topk_k = topk_k;
  std::vector<char> buf = bps::encode(codec, src, n, hint, seed);
  if (static_cast<int64_t>(buf.size()) > cap)
    return -static_cast<int64_t>(buf.size());
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<int64_t>(buf.size());
}

// ---- in-process (IPC) fast path -------------------------------------------
int bps_local_init(uint64_t key, uint64_t nbytes) {
  return bps::LocalInit(key, nbytes);
}

int bps_local_push(uint16_t worker, uint64_t key, uint8_t codec,
                   const void* buf, uint64_t nbytes) {
  return bps::LocalPush(worker, key, codec, 0,
                        static_cast<const char*>(buf), nbytes);
}

// Versioned variant: `version` != 0 arms the per-(worker, key) replay
// dedupe, making retry-engine re-sends idempotent.
int bps_local_push2(uint16_t worker, uint64_t key, uint8_t codec,
                    uint64_t version, const void* buf, uint64_t nbytes) {
  return bps::LocalPush(worker, key, codec, version,
                        static_cast<const char*>(buf), nbytes);
}

// Fills out (capacity cap); returns actual bytes >= 0, or negative error
// (-4 timeout, -5 buffer too small, -10 no server in this process).
int64_t bps_local_pull(uint64_t key, uint8_t codec, uint64_t version,
                       int timeout_ms, void* out, uint64_t cap) {
  std::vector<char> blob;
  int rc = bps::LocalPull(key, codec, version, timeout_ms, &blob);
  if (rc != 0) return rc;
  if (blob.size() > cap) return -5;
  std::memcpy(out, blob.data(), blob.size());
  return static_cast<int64_t>(blob.size());
}

// As bps_local_pull, additionally surfacing the membership epoch the
// returned ROUND closed under (the IPC analog of the TCP response
// header's stamp — the averaging divisor authority).
int64_t bps_local_pull2(uint64_t key, uint8_t codec, uint64_t version,
                        int timeout_ms, void* out, uint64_t cap,
                        uint64_t* out_epoch) {
  std::vector<char> blob;
  int rc = bps::LocalPull(key, codec, version, timeout_ms, &blob,
                          out_epoch);
  if (rc != 0) return rc;
  if (blob.size() > cap) return -5;
  std::memcpy(out, blob.data(), blob.size());
  return static_cast<int64_t>(blob.size());
}

// As bps_local_pull2, additionally surfacing the SERVED round (the TCP
// response header's version field): under bounded staleness
// (BYTEPS_STALENESS) it may differ from the requested round — requested
// minus served is the worker's effective staleness.
int64_t bps_local_pull3(uint64_t key, uint8_t codec, uint64_t version,
                        int timeout_ms, void* out, uint64_t cap,
                        uint64_t* out_epoch, uint64_t* out_round) {
  std::vector<char> blob;
  int rc = bps::LocalPull(key, codec, version, timeout_ms, &blob,
                          out_epoch, out_round);
  if (rc != 0) return rc;
  if (blob.size() > cap) return -5;
  std::memcpy(out, blob.data(), blob.size());
  return static_cast<int64_t>(blob.size());
}

// ---- TCP client -----------------------------------------------------------
void* bps_client_connect(const char* host, uint16_t port, int timeout_ms,
                         int recv_timeout_ms) {
  auto* c = new bps::Client();
  if (c->Connect(host, port, timeout_ms, recv_timeout_ms) != 0) {
    delete c;
    return nullptr;
  }
  return c;
}

int bps_client_init_key(void* client, uint64_t key, uint64_t nbytes) {
  return static_cast<bps::Client*>(client)->InitKey(key, nbytes);
}

int bps_client_push(void* client, uint64_t key, const void* data,
                    uint64_t nbytes, uint8_t codec, uint16_t worker_id) {
  return static_cast<bps::Client*>(client)->Push(key, data, nbytes, codec,
                                                 worker_id);
}

// Versioned + checksummed push: `version` != 0 arms the server-side
// (worker, key, version) replay dedupe; `crc` != 0 is verified server-side
// before the payload is summed (mismatch -> retryable kErr).
int bps_client_push2(void* client, uint64_t key, const void* data,
                     uint64_t nbytes, uint8_t codec, uint16_t worker_id,
                     uint64_t version, uint32_t crc) {
  return static_cast<bps::Client*>(client)->Push(key, data, nbytes, codec,
                                                 worker_id, version, crc);
}

int bps_client_pull(void* client, uint64_t key, void* data, uint64_t nbytes,
                    uint64_t version, uint8_t codec, uint64_t* out_bytes) {
  return static_cast<bps::Client*>(client)->Pull(key, data, nbytes, version,
                                                 codec, out_bytes);
}

// Checksummed pull: want_crc != 0 asks the server to checksum the
// response; *out_crc receives it (caller verifies — kept out of the C
// layer so the fault-injection harness can corrupt the buffer first).
// `worker_id` >= 0 refreshes the worker's membership lease server-side;
// *out_epoch receives the membership epoch the pulled ROUND closed
// under (low 16 bits — the divisor authority for averaging).
int bps_client_pull2(void* client, uint64_t key, void* data,
                     uint64_t nbytes, uint64_t version, uint8_t codec,
                     int want_crc, uint64_t* out_bytes, uint32_t* out_crc,
                     int worker_id, uint32_t* out_epoch) {
  uint16_t ep = 0;
  int rc = static_cast<bps::Client*>(client)->Pull(
      key, data, nbytes, version, codec, out_bytes, want_crc != 0, out_crc,
      worker_id, &ep);
  if (out_epoch != nullptr) *out_epoch = ep;
  return rc;
}

// As bps_client_pull2, additionally surfacing the SERVED round (response
// header version) — under bounded staleness (BYTEPS_STALENESS) the server
// answers from the newest closed round >= requested − K, and the worker
// reads its effective staleness off this stamp.
int bps_client_pull3(void* client, uint64_t key, void* data,
                     uint64_t nbytes, uint64_t version, uint8_t codec,
                     int want_crc, uint64_t* out_bytes, uint32_t* out_crc,
                     int worker_id, uint32_t* out_epoch,
                     uint64_t* out_round) {
  uint16_t ep = 0;
  int rc = static_cast<bps::Client*>(client)->Pull(
      key, data, nbytes, version, codec, out_bytes, want_crc != 0, out_crc,
      worker_id, &ep, out_round);
  if (out_epoch != nullptr) *out_epoch = ep;
  return rc;
}

// `worker_id` >= 0 identifies the worker to the server's membership
// layer (lease refresh on barrier, DEPARTED marking on shutdown, lease
// heartbeat + rejoin on ping); -1 keeps the anonymous legacy frame.
int bps_client_barrier(void* client, int worker_id) {
  return static_cast<bps::Client*>(client)->Barrier(worker_id);
}

int bps_client_shutdown(void* client, int worker_id) {
  return static_cast<bps::Client*>(client)->Shutdown(worker_id);
}

int bps_client_ping(void* client, int64_t* server_ns, int64_t* rtt_ns,
                    int worker_id) {
  return static_cast<bps::Client*>(client)->Ping(server_ns, rtt_ns,
                                                 worker_id);
}

// Membership epoch (low 16 bits) stamped on the last response this client
// parsed — polled per op by the worker to detect membership changes.
int bps_client_epoch(void* client) {
  return static_cast<int>(static_cast<bps::Client*>(client)->epoch());
}

int bps_client_members(void* client, uint64_t* epoch, uint32_t* live_count,
                       uint32_t* num_workers, uint8_t* bitmap,
                       uint32_t cap) {
  return static_cast<bps::Client*>(client)->Members(
      epoch, live_count, num_workers, bitmap, cap);
}

// Per-key (u64 key, u64 round, u64 nbytes) watermark triples into `out`;
// *got = bytes written. The rejoin round-adoption handshake.
int bps_client_rounds(void* client, void* out, uint64_t cap,
                      uint64_t* got) {
  return static_cast<bps::Client*>(client)->Rounds(out, cap, got);
}

// Mid-stream worker admission (kJoin): a fresh worker id (the server
// grows its membership table) or a previously evicted/departed one is
// admitted at a round boundary; *out_epoch receives the post-admission
// epoch. Adopt round watermarks (bps_client_rounds) before pushing.
int bps_client_join(void* client, int worker_id, uint64_t* out_epoch) {
  return static_cast<bps::Client*>(client)->Join(worker_id, out_epoch);
}

const char* bps_client_last_error(void* client) {
  return static_cast<bps::Client*>(client)->last_error();
}

int bps_client_is_dead(void* client) {
  return static_cast<bps::Client*>(client)->dead() ? 1 : 0;
}

void bps_client_free(void* client) {
  delete static_cast<bps::Client*>(client);
}

}  // extern "C"
