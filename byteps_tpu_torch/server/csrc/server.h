// DCN summation service — the reference's byteps/server/server.{h,cc}
// (BytePSServer + BytePSHandler over ps::KVServer<char>) rebuilt on a plain
// TCP van: workers INIT/PUSH/PULL codec-encoded partitions by u64 key; the
// server decodes each push into an fp32 accumulator on an engine thread
// pool (decompress→sum, reference server.cc push handler), and answers
// pulls when all DMLC_NUM_WORKER workers contributed the round (sync) or
// immediately (BYTEPS_ENABLE_ASYNC), re-encoding the result with the
// requested codec (recompress-before-pull, SURVEY §2.2/§3.3).
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace bps {

// Returns 0 on success. num_workers: pushes per round per key; engine
// threads: decode/sum pool size; async: no per-round barrier.
// `pull_timeout_ms` > 0 expires pulls waiting past the deadline with kErr
// (dead-worker fail-fast; reference analog: ps-lite heartbeat/resender,
// SURVEY §5.3). `server_id` labels trace output. `schedule` enables
// priority-ordered engine work by key (BYTEPS_SERVER_ENABLE_SCHEDULE).
// `lease_ms` > 0 arms ELASTIC WORKER MEMBERSHIP (BYTEPS_WORKER_LEASE_MS):
// every worker holds a lease refreshed by its pushes/pulls and kPing
// heartbeats; a worker silent past the lease is EVICTED — the membership
// epoch bumps, open rounds re-target the live worker set (partial sums
// with contributions from the dead worker are scaled by live/contributors
// so the global *average* stays unbiased), stuck barriers release over
// the live set, and the server exits once every worker is departed or
// evicted (a dead worker can no longer stall its peers' pulls, barriers,
// or teardown). A later heartbeat from an evicted worker RE-ADMITS it
// (epoch bumps again); pushes from an evicted worker are rejected with a
// "worker evicted" kErr until it rejoins, so its stale rounds can never
// leak into a post-eviction sum. 0 = fixed membership (legacy).
// `staleness` > 0 arms BOUNDED-STALENESS rounds (BYTEPS_STALENESS=K, sync
// mode only — async is the K=inf limit): a pull for round v is served from
// the newest CLOSED round v' >= v-K instead of blocking on v itself, and a
// pull that would otherwise wait past the bound FORCE-closes open rounds
// (each over its contributors, quorum-scaled exactly like an
// eviction-shrunk round) up to v-K so one straggler can no longer set the
// global step time. A straggler's push for a round that already closed is
// consumed silently (watermark advanced, payload dropped) — backpressure
// and catch-up, never an error. K=0 is bit-identical to the synchronous
// tier. Responses stamp the SERVED round in the version field, so the
// worker knows its effective staleness.
int StartServer(uint16_t port, int num_workers, int engine_threads,
                bool async, int pull_timeout_ms, int server_id,
                bool schedule, int lease_ms, int staleness);
// Current membership epoch of the in-process server (0 if none running) —
// the IPC-path analog of the epoch carried in every TCP response header.
uint64_t ServerEpoch();
// Membership snapshot of the in-process server: *epoch, *live_count, and
// up to `cap` bytes of the per-worker live bitmap. Returns num_workers,
// or -10 when no server runs in this process.
int ServerMembers(uint64_t* epoch, uint32_t* live_count, uint8_t* bitmap,
                  uint32_t cap);
// Mid-stream worker ADMISSION (the IPC analog of kJoin; scale-up
// elasticity): admit `worker` — a fresh id beyond the configured count
// (the membership table and every key store's per-worker vectors GROW
// before the admission is published, so the join lands at a round
// boundary) or a previously evicted/departed one. Returns the
// post-admission epoch, -1 for an out-of-range id, -2 under fixed
// membership (lease disabled) for an unknown id, -10 with no server.
int64_t ServerJoin(uint16_t worker);
// Blocks until the server stops (all workers sent kShutdown, or StopServer).
void WaitServer();
void StopServer();

// Chrome-trace collection (reference: BYTEPS_TRACE_* server-side timestamps,
// the joapolarbear fork's defining capability). Events carry absolute
// CLOCK_REALTIME microseconds so they merge with worker traces.
void ServerTraceEnable(bool on);
// Writes chrome trace JSON; returns events dumped, negative on I/O error.
int ServerTraceDump(const char* path);

// In-process (colocated) fast path — BYTEPS_ENABLE_IPC: a worker living in
// the same process as the server (joint role) reads/writes the store
// directly instead of looping through TCP. Round completion still answers
// remote TCP pulls.
int LocalInit(uint64_t key, uint64_t nbytes);
// `version` != 0 arms the per-(worker, key) replay dedupe (a re-sent push
// with an already-applied version is dropped, not double-summed).
int LocalPush(uint16_t worker, uint64_t key, uint8_t codec,
              uint64_t version, const char* buf, size_t len);
// Blocks up to timeout_ms for round `version`; fills `out` with the
// response encoded as `codec`. *out_epoch (optional) receives the
// membership epoch the returned ROUND closed under — the averaging
// divisor authority, same contract as the TCP response header stamp.
// *out_version (optional) receives the SERVED round — under bounded
// staleness it may differ from the requested one (the TCP analog is the
// response header's version field).
int LocalPull(uint64_t key, uint8_t codec, uint64_t version, int timeout_ms,
              std::vector<char>* out, uint64_t* out_epoch = nullptr,
              uint64_t* out_version = nullptr);

}  // namespace bps
