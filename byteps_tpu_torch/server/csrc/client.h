// DCN worker-side client — the reference's ps::KVWorker<char>::ZPush/ZPull
// (3rdparty/ps-lite include/ps/kv_app.h) reduced to the summation service's
// needs. One Client = one TCP connection with strictly serial
// request/response (parallelism = several Client instances, one per
// scheduler pool thread, mirroring ps-lite's per-thread customers).
//
// Return codes: 0 ok; >0 server kErr (message via last_error());
// -2 send failed / connection dead; -3 recv failed/closed; -4 bad magic;
// -5 response larger than the caller's buffer (stream drained, still
// framed); -6 response key does not match the request (desynchronized
// stream); -7 receive timeout (dead/stalled server).
//
// Any error that can leave bytes of a late/foreign frame in the stream
// (-3/-4/-6/-7) closes the connection: a timed-out response would
// otherwise be consumed by the NEXT request on this client and silently
// return another round's (or key's) data. Subsequent calls fail fast
// with -2; the owner reconnects or reports.
#pragma once

#include <atomic>
#include <cstdint>
#include <mutex>
#include <string>

#include "common.h"

namespace bps {

class Client {
 public:
  ~Client();
  // Retries until the server accepts or timeout_ms elapses (workers may
  // start before servers; ps-lite's scheduler rendezvous absorbs this in
  // the reference). recv_timeout_ms > 0 arms SO_RCVTIMEO so a pull against
  // a dead server errors instead of blocking a scheduler thread forever.
  int Connect(const std::string& host, uint16_t port, int timeout_ms,
              int recv_timeout_ms);
  int InitKey(uint64_t key, uint64_t nbytes);
  // Push `nbytes` of codec-encoded payload as `worker_id`. `version` is
  // the round this push belongs to (0 = unversioned): the server drops a
  // replayed (worker, key, version) instead of double-summing, which is
  // what makes the worker retry engine's re-sent pushes safe. `crc` is
  // the payload checksum as computed by wire_crc (0 = unchecked); a
  // mismatch is rejected server-side with a retryable kErr.
  int Push(uint64_t key, const void* data, uint64_t nbytes, uint8_t codec,
           uint16_t worker_id, uint64_t version = 0, uint32_t crc = 0);
  // Blocks until the server completed round `version`; response encoded as
  // `codec` is written into data (capacity `nbytes`); *out_bytes = actual.
  // want_crc requests a checksummed response; *out_crc receives the
  // server-computed wire_crc of the payload (0 when not requested) for
  // the CALLER to verify — verification is deliberately not done here so
  // the fault-injection layer can corrupt the buffer in between.
  // `worker_id` >= 0 rides the request so the server refreshes that
  // worker's membership lease (a worker blocked in a long pull is alive).
  // *out_epoch receives the membership epoch the pulled ROUND closed
  // under (its header stamp) — the divisor authority for averaging.
  // *out_round receives the SERVED round (response header version):
  // under bounded staleness (BYTEPS_STALENESS) it may differ from the
  // requested round — requested − served is the effective staleness.
  int Pull(uint64_t key, void* data, uint64_t nbytes, uint64_t version,
           uint8_t codec, uint64_t* out_bytes, bool want_crc = false,
           uint32_t* out_crc = nullptr, int worker_id = -1,
           uint16_t* out_epoch = nullptr, uint64_t* out_round = nullptr);
  // `worker_id` >= 0 rides the barrier/shutdown frame so the server can
  // refresh the worker's lease (barrier) or mark it DEPARTED (shutdown);
  // -1 keeps the anonymous legacy frame.
  int Barrier(int worker_id = -1);
  int Shutdown(int worker_id = -1);
  // Clock-offset probe: *server_ns = server CLOCK_REALTIME at serve time,
  // *rtt_ns = local round-trip (offset ≈ server_ns + rtt/2 − local_now).
  // `worker_id` >= 0 makes the probe the worker's membership lease
  // HEARTBEAT (and the rejoin signal for an evicted worker).
  int Ping(int64_t* server_ns, int64_t* rtt_ns, int worker_id = -1);
  // Membership query: *epoch, *live_count, and up to `cap` bytes of the
  // per-worker live bitmap; *num_workers = configured worker count.
  int Members(uint64_t* epoch, uint32_t* live_count, uint32_t* num_workers,
              uint8_t* bitmap, uint32_t cap);
  // Per-key round watermarks (u64 key, u64 round, u64 nbytes triples)
  // into `out` (cap bytes); *got = actual bytes. The rejoin handshake.
  int Rounds(void* out, uint64_t cap, uint64_t* got);
  // Mid-stream worker ADMISSION (kJoin; scale-up elasticity): admit
  // `worker_id` — a fresh id (the server grows its membership table) or
  // a previously evicted/departed one — at a round boundary. *out_epoch
  // (optional) receives the post-admission membership epoch. The caller
  // must adopt round watermarks (Rounds) before pushing. Returns -8 for
  // an id outside [0, 0xFFFE] (it would truncate in the wire encoding
  // and admit a DIFFERENT worker).
  int Join(int worker_id, uint64_t* out_epoch = nullptr);
  // Membership epoch (low 16 bits) carried by the LAST response this
  // client parsed — workers poll it per op to detect membership changes
  // without an extra round trip.
  uint16_t epoch() const { return epoch_.load(std::memory_order_relaxed); }
  const char* last_error() const { return last_err_.c_str(); }
  // True once a desynchronizing error closed the socket; the owner should
  // drop this client and connect a fresh one.
  bool dead() const { return fd_ < 0; }

 private:
  int Roundtrip(Cmd cmd, uint64_t key, uint64_t version, const void* req,
                uint32_t req_len, void* in, uint64_t in_cap, uint64_t* got,
                uint8_t flags, uint16_t reserved, uint64_t* resp_version,
                uint32_t req_crc = 0, uint32_t* resp_crc = nullptr,
                uint16_t* resp_reserved = nullptr);
  // Close the socket after a stream-desynchronizing error; later calls
  // return -2 instead of misparsing stale frames.
  void Kill();

  int fd_ = -1;
  std::mutex mu_;
  std::string last_err_;
  std::atomic<uint16_t> epoch_{0};
};

}  // namespace bps
