#include "server.h"

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#include "codec.h"
#include "common.h"
#include "threadpool.h"

namespace bps {
namespace {

int64_t realtime_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}

int64_t steady_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// vector<char> whose resize() default-initializes instead of zeroing:
// payload buffers are filled by recv_all immediately after sizing, and the
// avoided memset is a full extra memory pass per 4 MB push.
template <class T>
struct uninit_alloc : std::allocator<T> {
  template <class U>
  struct rebind {
    using other = uninit_alloc<U>;
  };
  template <class U>
  void construct(U* p) noexcept {
    ::new (static_cast<void*>(p)) U;
  }
  template <class U, class... Args>
  void construct(U* p, Args&&... args) {
    ::new (static_cast<void*>(p)) U(std::forward<Args>(args)...);
  }
};
using RawBuf = std::vector<char, uninit_alloc<char>>;
// Accumulator/snapshot buffers skip value-initialization too: a closing
// round MOVES accum into the snapshot and must re-allocate; zero-filling
// 4 MB per round per key costs real memory bandwidth on the engine's
// critical path, and the first push of a round overwrites (raw memcpy) or
// explicitly zero+sums (other codecs) anyway.
using FloatBuf = std::vector<float, uninit_alloc<float>>;

// Ordered executor over the shared engine pool, one per (key, worker).
// A worker's pushes for one key are applied in RECEIVE order: two
// pipelined pushes (rounds v and v+1) submitted to an unordered pool could
// otherwise swap, crediting v+1's payload to round v and corrupting both
// sums. Keyed by (key, worker) — NOT by connection — so the ordering
// survives a client reconnect (a timed-out socket is killed client-side
// and the next push arrives on a fresh connection, but must still land
// after the old connection's queued push). Different keys and different
// workers fan out across the pool in parallel.
struct Strand {
  std::mutex mu;
  std::deque<std::function<void()>> q;
  bool running = false;
};

// Per-connection state. shared_ptr-owned by the conn thread, pending
// pulls, barrier waiters, and in-flight responses, so a response racing a
// disconnect can never touch a freed mutex or a recycled fd number: the
// `closed` flag (guarded by send_mu) gates every write, and the fd is only
// closed under that same lock.
struct Conn {
  uint64_t id = 0;
  int fd = -1;
  std::mutex send_mu;  // serializes frame writes; also guards `closed`
  bool closed = false;
};
using ConnPtr = std::shared_ptr<Conn>;

struct PendingPull {
  ConnPtr conn;
  uint64_t version;  // respond when store version >= this (under bounded
                     // staleness: the requested round minus K — the
                     // oldest round this pull may legally be served from)
  uint8_t codec;     // response encoding the worker asked for
  bool want_crc;     // checksummed response requested
  int64_t enq_ms;    // steady clock, for the timeout sweep
  uint64_t force_min = 0;  // bounded staleness: the round this pull may
                           // FORCE-close up to (0 = may not force) — a
                           // later push apply re-checks it so a parked
                           // pull can make progress off the straggler
};

struct DeferredPush {
  uint16_t worker;
  uint8_t codec;
  uint64_t version;
  std::shared_ptr<RawBuf> buf;
};

// Per-key state (reference: BytePSArray store + the "all workers arrived →
// answer queued pulls" logic in BytePSHandler). `accum` receives the
// in-progress round; on completion it is MOVED into an immutable
// shared_ptr snapshot (`result`) and a fresh UNINITIALIZED accumulator
// allocated (the next round's first push overwrites or zero-fills it —
// see ApplyPushLocked), so responses serialize from the snapshot OUTSIDE
// the key mutex — large sends never stall other consumers of the key.
struct KeyStore {
  std::mutex mu;
  std::condition_variable cv;  // local (in-process) pulls wait here
  // Membership epoch at the moment `result`'s round CLOSED: pull
  // responses are stamped with THIS (not the send-time epoch), so a
  // survivor averaging a round that closed under the old membership
  // divides by the old live count even when the response is delivered
  // after a later eviction bumped the epoch.
  uint64_t result_epoch = 0;
  // Dense element count, immutable after creation. Validation MUST read
  // this, not accum.size(): a closing round MOVES accum out and
  // reallocates it under mu, so an unlocked accum.size() can observe 0
  // and spuriously reject a concurrent pipelined push.
  size_t n_elems = 0;
  FloatBuf accum;
  std::shared_ptr<const FloatBuf> result;
  uint64_t version = 0;
  uint32_t arrived = 0;
  std::vector<uint8_t> pushed;         // per-worker arrival bitmap (sync)
  // Highest push version already summed per worker (0 = none). A re-sent
  // push from the worker retry engine carries the same (worker, key,
  // version) as the original; when the original DID land (the lost frame
  // was the ack/response, not the request), the replay must be dropped
  // here instead of double-summing the round.
  std::vector<uint64_t> applied_version;
  std::vector<DeferredPush> deferred;  // next-round pushes that came early
  CodecHint hint;         // evolves with every push (current open round)
  CodecHint result_hint;  // frozen copy of `hint` when `result`'s round
                          // closed — responses for that round encode with
                          // THIS, so a next-round push changing topk k or
                          // dithering params cannot retro-change the wire
                          // format of a round already being served
  std::vector<PendingPull> pending;
  // one re-encode per (version, codec): every worker pulls the same round
  uint64_t cache_version = 0;
  uint8_t cache_codec = 0xFF;
  std::shared_ptr<const std::vector<char>> cache_blob;
  // per-worker push-ordering strands (see Strand)
  std::mutex strands_mu;
  std::unordered_map<uint16_t, std::shared_ptr<Strand>> strands;
};

// Server-side chrome-trace stages (SURVEY §5.1 — the fork's server-side
// timestamp capability). Timestamps are absolute CLOCK_REALTIME so worker
// traces (which record their wall-clock origin) can be aligned.
enum TraceStage : uint8_t {
  kTrPushRecv = 0,
  kTrSum = 1,
  kTrPullResp = 2,
  kTrRound = 3,
  kTrMember = 4,  // key = worker id, len = live count,
                  // codec = 0 evict / 1 rejoin / 2 mid-stream join
};
const char* kTraceStageName[] = {"PUSH_RECV", "SUM", "PULL_RESP", "ROUND",
                                 "MEMBER"};

struct TraceEv {
  int64_t ts_us;
  int32_t dur_us;
  uint64_t key;
  uint32_t len;
  uint8_t stage;
  uint8_t codec;
};

constexpr size_t kMaxTraceEvents = 1u << 21;

// Ceiling on worker ids a kJoin may grow the membership table to —
// matches the worker-side Members() bitmap buffer (1024 bytes); a
// malformed frame must not drive an unbounded per-key vector resize.
constexpr uint16_t kMaxWorkers = 1024;

class Server {
 public:
  int Start(uint16_t port, int num_workers, int engine_threads, bool async,
            int pull_timeout_ms, int server_id, bool schedule,
            int lease_ms, int staleness) {
    num_workers_.store(num_workers);
    async_ = async;
    pull_timeout_ms_ = pull_timeout_ms;
    server_id_ = server_id;
    schedule_ = schedule;
    lease_ms_ = lease_ms;
    // bounded staleness is a SYNC-mode ladder; async is its K=inf limit
    // and keeps its own free-running code path
    staleness_ = async ? 0 : std::max(0, staleness);
    // membership starts fully live even with the lease disabled, so every
    // live-set consumer (round completion, barriers, shutdown gate) reads
    // one uniform source of truth
    member_state_.assign(num_workers_, kLive);
    last_seen_ms_.assign(num_workers_, steady_ms());
    live_workers_.store(num_workers_);
    epoch_.store(0);
    {
      std::lock_guard<std::mutex> lk(members_mu_);
      PublishMembersLocked();
    }
    engine_ = std::make_unique<ThreadPool>(engine_threads);
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return -1;
    int one = 1;
    ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(port);
    if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr),
               sizeof(addr)) != 0) {
      ::close(listen_fd_);
      return -2;
    }
    if (::listen(listen_fd_, 128) != 0) {
      ::close(listen_fd_);
      return -3;
    }
    running_ = true;
    accept_thread_ = std::thread([this] { AcceptLoop(); });
    if (pull_timeout_ms_ > 0 || lease_ms_ > 0) {
      sweep_thread_ = std::thread([this] { SweepLoop(); });
    }
    return 0;
  }

  uint64_t Epoch() const { return epoch_.load(); }

  int MembersInfo(uint64_t* epoch, uint32_t* live_count, uint8_t* bitmap,
                  uint32_t cap) {
    auto m = Members();
    // the SNAPSHOT's epoch, never a fresh epoch_.load(): a concurrent
    // membership change must not label an old live count with a new
    // epoch (workers cache epoch->live as the averaging divisor)
    if (epoch != nullptr) *epoch = m->epoch;
    if (live_count != nullptr) *live_count = m->count;
    if (bitmap != nullptr && !m->live.empty()) {
      std::memcpy(bitmap, m->live.data(),
                  std::min<size_t>(cap, m->live.size()));
    }
    return static_cast<int>(m->live.size());
  }

  void Wait() {
    std::unique_lock<std::mutex> lk(done_mu_);
    done_cv_.wait(lk, [this] { return !running_.load(); });
  }

  void Stop() {
    // serialize concurrent stops (worker-initiated auto-stop can race an
    // explicit StopServer); the loser blocks until teardown completes so
    // the caller may safely retire the server afterwards
    std::lock_guard<std::mutex> stop_lk(stop_mu_);
    bool was = running_.exchange(false);
    if (!was) return;
    if (listen_fd_ >= 0) ::shutdown(listen_fd_, SHUT_RDWR);
    if (listen_fd_ >= 0) ::close(listen_fd_);
    {
      // SHUT_RDWR (without close) unblocks every conn thread's recv AND
      // any engine thread blocked in a send to a stopped reader. No
      // send_mu here — a sender stuck in send_all() holds send_mu, and
      // only this shutdown can unblock it (lock-free is safe: a conn
      // still in the map has not run its teardown, whose erase-then-close
      // sequence is ordered by conn_mu_, so the fd is still open).
      std::lock_guard<std::mutex> lk(conn_mu_);
      for (auto& [id, c] : conns_) ::shutdown(c->fd, SHUT_RDWR);
    }
    if (accept_thread_.joinable() &&
        accept_thread_.get_id() != std::this_thread::get_id()) {
      accept_thread_.join();
    }
    if (sweep_thread_.joinable()) sweep_thread_.join();
    {
      // conn threads are detached (a long-running server must not accrete
      // one joinable std::thread per reconnect); wait on the live count
      std::unique_lock<std::mutex> lk(threads_mu_);
      threads_cv_.wait(lk, [this] { return live_conn_threads_ == 0; });
    }
    if (engine_) engine_->Stop();
    {
      // conn threads closed their own fds on exit; this sweeps any that
      // never reached their cleanup (shouldn't happen, but harmless)
      std::lock_guard<std::mutex> lk(conn_mu_);
      for (auto& [id, c] : conns_) CloseConn(c);
      conns_.clear();
    }
    // wake any in-process pulls so joint-role callers fail fast
    {
      std::lock_guard<std::mutex> lk(store_mu_);
      for (auto& [k, ks] : store_) ks->cv.notify_all();
    }
    done_cv_.notify_all();
  }

  void TraceEnable(bool on) { trace_on_ = on; }

  int TraceDump(const char* path) {
    std::vector<TraceEv> evs;
    {
      std::lock_guard<std::mutex> lk(trace_mu_);
      evs = trace_;
    }
    FILE* f = std::fopen(path, "w");
    if (f == nullptr) return -1;
    // pid 10000+server_id keeps server rows apart from worker ranks when
    // traces are merged
    std::fprintf(f, "{\"traceEvents\":[");
    for (size_t i = 0; i < evs.size(); ++i) {
      const auto& e = evs[i];
      std::fprintf(
          f,
          "%s{\"name\":\"key%llu\",\"cat\":\"byteps_server\",\"ph\":\"X\","
          "\"ts\":%lld,\"dur\":%d,\"pid\":%d,\"tid\":\"%s\","
          "\"args\":{\"key\":%llu,\"len\":%u,\"codec\":%u}}",
          i ? "," : "", static_cast<unsigned long long>(e.key),
          static_cast<long long>(e.ts_us), e.dur_us, 10000 + server_id_,
          kTraceStageName[e.stage],
          static_cast<unsigned long long>(e.key), e.len, e.codec);
    }
    std::fprintf(f,
                 "],\"displayTimeUnit\":\"ms\",\"metadata\":{"
                 "\"role\":\"server\",\"server_id\":%d,"
                 "\"clock\":\"CLOCK_REALTIME_us\"}}",
                 server_id_);
    std::fclose(f);
    return static_cast<int>(evs.size());
  }

  bool IsRunning() const { return running_.load(); }

  // ---- in-process (IPC) fast path ----------------------------------------
  // Every entry checks running_: after a worker-driven shutdown stopped
  // the server, a later joint-role PSWorker must fail loudly instead of
  // silently reading/writing the stopped server's leaked store.
  int LocalInit(uint64_t key, uint64_t nbytes) {
    if (!running_) return -10;
    if (nbytes == 0 || nbytes > kMaxFrameLen || nbytes % 4 != 0) return -1;
    KeyStore* ks = GetOrCreate(key, nbytes / 4);
    return ks->n_elems * 4 == nbytes ? 0 : -2;
  }

  int LocalPush(uint16_t worker, uint64_t key, uint8_t codec,
                uint64_t version, const char* buf, size_t len) {
    if (!running_) return -10;
    KeyStore* ks = Get(key);
    if (ks == nullptr) return -1;
    // bounds/liveness hold in ASYNC mode too: an out-of-range or evicted
    // worker id must not silently sum into the free-running aggregate
    // (it would also never refresh a lease slot, leaving kMembers lying)
    if (worker >= num_workers_) return -2;
    // IPC analog of the TCP path's "worker evicted" kErr
    if (!WorkerLive(worker)) return -11;
    if (!async_ && staleness_ <= 0 && lease_ms_ > 0 && version != 0) {
      // stale-round guard (see the kPush handler): a round the worker
      // was evicted out of closed without it — reject, don't sum
      std::lock_guard<std::mutex> lk(ks->mu);
      if (version <= ks->version && worker < ks->applied_version.size() &&
          version > ks->applied_version[worker]) {
        return -11;
      }
    }
    Touch(worker, /*admit=*/false);
    const int64_t n = static_cast<int64_t>(ks->n_elems);
    if (!validate_payload(codec, buf, len, n)) return -3;
    auto owned = std::make_shared<RawBuf>(buf, buf + len);
    ApplyPush(ks, key, worker, codec, version, std::move(owned));
    return 0;
  }

  int LocalPull(uint64_t key, uint8_t codec, uint64_t version,
                int timeout_ms, std::vector<char>* out,
                uint64_t* out_epoch, uint64_t* out_version) {
    if (!running_) return -10;
    KeyStore* ks = Get(key);
    if (ks == nullptr) return -1;
    std::shared_ptr<const FloatBuf> snap;
    CodecHint hint;
    uint64_t v = 0;
    uint64_t epoch = 0;
    // bounded staleness: same serve/force ladder as the TCP path
    const uint64_t serve_min = ServeMin(version);
    const uint64_t force_min = ForceMin(version);
    {
      std::unique_lock<std::mutex> lk(ks->mu);
      const auto deadline = std::chrono::steady_clock::now() +
                            std::chrono::milliseconds(timeout_ms);
      while (running_ &&
             !(async_ ? ks->version > 0 : ks->version >= serve_min)) {
        if (force_min > ks->version && ks->arrived > 0) {
          std::vector<ReadyResp> released;
          auto memb = Members();
          ForceAdvanceLocked(ks, *memb, force_min, &released);
          if (!released.empty()) {
            // TCP pulls satisfied by OUR force-close must not wait for
            // this local pull's own condition — hand them off now
            lk.unlock();
            DispatchReady(key, ks, released);
            lk.lock();
          }
          continue;
        }
        if (ks->cv.wait_until(lk, deadline) == std::cv_status::timeout) {
          return -4;
        }
      }
      if (!running_) return -5;
      v = ks->version;
      if (async_) {
        snap = std::make_shared<const FloatBuf>(ks->accum);
        hint = ks->hint;
        epoch = epoch_.load();
      } else {
        snap = ks->result;
        hint = ks->result_hint;
        epoch = ks->result_epoch;
      }
    }
    if (out_epoch != nullptr) *out_epoch = epoch;
    if (out_version != nullptr) *out_version = v;
    *out = *EncodeResponse(ks, snap, hint, v, codec);
    return 0;
  }

 private:
  void Trace(uint8_t stage, uint64_t key, uint32_t len, uint8_t codec,
             int64_t t0_ns) {
    if (!trace_on_.load(std::memory_order_relaxed)) return;
    TraceEv e;
    e.ts_us = t0_ns / 1000;
    e.dur_us = static_cast<int32_t>((realtime_ns() - t0_ns) / 1000);
    e.key = key;
    e.len = len;
    e.stage = stage;
    e.codec = codec;
    std::lock_guard<std::mutex> lk(trace_mu_);
    if (trace_.size() < kMaxTraceEvents) trace_.push_back(e);
  }

  void AcceptLoop() {
    while (running_) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) {
        // EINTR: a signal (the embedding process — jax/XLA, profilers —
        // delivers them to arbitrary threads) interrupted accept;
        // ECONNABORTED: the peer gave up while queued. Neither means the
        // listening socket is done — exiting here silently stops the
        // server accepting ANYTHING while clients still see the port as
        // bound (their connects then fail for their whole retry budget).
        // Only a real teardown (Stop() closes listen_fd_ → EBADF) or an
        // unrecoverable socket error ends the loop.
        if (errno == EINTR || errno == ECONNABORTED) continue;
        break;
      }
      set_nodelay(fd);
      set_bufsizes(fd);
      auto c = std::make_shared<Conn>();
      c->fd = fd;
      {
        std::lock_guard<std::mutex> lk(conn_mu_);
        c->id = next_conn_id_++;
        conns_[c->id] = c;
      }
      {
        std::lock_guard<std::mutex> lk(threads_mu_);
        ++live_conn_threads_;
      }
      // detached: per-connection teardown reclaims everything (Conn, fd,
      // live count); Stop() waits on the count, so no per-reconnect
      // std::thread object accretes for the server's lifetime
      std::thread([this, c] {
        ConnLoop(c);
        {
          std::lock_guard<std::mutex> lk(threads_mu_);
          --live_conn_threads_;
        }
        threads_cv_.notify_all();
      }).detach();
    }
  }

  // Mark closed and close the fd, exactly once, under send_mu so no frame
  // write can race the close (or hit a recycled fd number).
  static void CloseConn(const ConnPtr& c) {
    std::lock_guard<std::mutex> lk(c->send_mu);
    if (!c->closed) {
      c->closed = true;
      ::close(c->fd);
    }
  }

  // Engine submission honoring BYTEPS_SERVER_ENABLE_SCHEDULE: with
  // scheduling on, tasks carry the key as priority (lower key =
  // earlier-declared tensor = higher priority — the worker scheduler's own
  // (priority, key) order) so a contended engine sums and answers
  // high-priority partitions first.
  void SubmitEngine(uint64_t key, std::function<void()> fn) {
    if (schedule_) {
      engine_->SubmitPriority(key, std::move(fn));
    } else {
      engine_->Submit(std::move(fn));
    }
  }

  // Enqueue `fn` on the key's per-worker strand: tasks run on the engine
  // pool but strictly in post order for that (key, worker).
  void PostOrdered(KeyStore* ks, uint64_t key, uint16_t worker,
                   std::function<void()> fn) {
    std::shared_ptr<Strand> st;
    {
      std::lock_guard<std::mutex> lk(ks->strands_mu);
      auto& slot = ks->strands[worker];
      if (!slot) slot = std::make_shared<Strand>();
      st = slot;
    }
    bool start = false;
    {
      std::lock_guard<std::mutex> lk(st->mu);
      st->q.push_back(std::move(fn));
      if (!st->running) {
        st->running = true;
        start = true;
      }
    }
    if (start) {
      if (schedule_) {
        SubmitEngine(key, [this, st, key] { RunStrandOne(st, key); });
      } else {
        engine_->Submit([st] {
          for (;;) {
            std::function<void()> task;
            {
              std::lock_guard<std::mutex> lk(st->mu);
              if (st->q.empty()) {
                st->running = false;
                return;
              }
              task = std::move(st->q.front());
              st->q.pop_front();
            }
            task();
          }
        });
      }
    }
  }

  // Scheduled strand pump: ONE task per engine submission, continuation
  // re-enqueued through the priority lane — a low-priority key receiving a
  // steady push stream must yield to higher-priority work between tasks
  // instead of monopolizing an engine thread with a drain loop.
  void RunStrandOne(const std::shared_ptr<Strand>& st, uint64_t key) {
    std::function<void()> task;
    {
      std::lock_guard<std::mutex> lk(st->mu);
      if (st->q.empty()) {
        st->running = false;
        return;
      }
      task = std::move(st->q.front());
      st->q.pop_front();
    }
    task();
    bool more;
    {
      std::lock_guard<std::mutex> lk(st->mu);
      more = !st->q.empty();
      if (!more) st->running = false;
    }
    if (more) {
      SubmitEngine(key, [this, st, key] { RunStrandOne(st, key); });
    }
  }

  // ---- elastic worker membership (leases + epochs) ------------------------
  // Reference failure story: ps-lite's scheduler heartbeat. The csrc
  // server completes a key's sum only when every expected worker arrived
  // and releases a barrier only at the full worker count, so ONE dead or
  // wedged worker deadlocks every key, every barrier, and every surviving
  // worker's wait() forever. With `lease_ms_` > 0 each worker holds a
  // lease refreshed by its pushes/pulls/heartbeats; expiry EVICTS it —
  // the membership epoch bumps (carried in every response header so
  // workers learn on their next op), open rounds re-target the live set,
  // and stuck barriers release over the survivors.
  enum MemberState : uint8_t { kEvicted = 0, kLive = 1, kDeparted = 2 };

  struct Membership {
    std::vector<uint8_t> live;  // 1 = live, indexed by worker id
    uint32_t count = 0;
    uint64_t epoch = 0;  // epoch this snapshot was published under —
                         // round closes stamp THIS, keeping the quorum
                         // scale and the epoch label consistent even
                         // when an eviction publishes mid-close
  };

  // Lock-free snapshot for the data plane: every push consults the
  // membership (round-completion targeting), and taking the global
  // members_mu_ + allocating a fresh vector under each per-key mutex
  // would serialize pushes to DIFFERENT keys on one lock. Membership
  // changes are rare; publishers rebuild the immutable snapshot under
  // members_mu_, readers atomic-load the shared_ptr.
  std::shared_ptr<const Membership> Members() {
    return std::atomic_load(&members_snap_);
  }

  // call with members_mu_ held
  void PublishMembersLocked() {
    auto snap = std::make_shared<Membership>();
    snap->live.resize(member_state_.size());
    for (size_t i = 0; i < member_state_.size(); ++i) {
      snap->live[i] = member_state_[i] == kLive ? 1 : 0;
    }
    const int live = live_workers_.load();
    snap->count = static_cast<uint32_t>(live > 0 ? live : 0);
    snap->epoch = epoch_.load();
    std::atomic_store(&members_snap_,
                      std::shared_ptr<const Membership>(std::move(snap)));
  }

  bool WorkerLive(uint16_t worker) {
    if (lease_ms_ <= 0) return true;
    // size read under the lock: a concurrent kJoin GROWS member_state_
    // (vector reallocation), so an unlocked size() probe is a race
    std::lock_guard<std::mutex> lk(members_mu_);
    if (worker >= member_state_.size()) return true;
    return member_state_[worker] == kLive;
  }

  // Refresh `worker`'s lease. With `admit`, an evicted/departed worker is
  // RE-ADMITTED (the kPing-heartbeat rejoin path): the epoch bumps and
  // the worker is expected in rounds again. Pushes/pulls deliberately do
  // NOT admit — an evicted worker must first adopt the current epoch and
  // round watermarks (kMembers/kRounds) or its stale rounds would leak
  // into post-eviction sums.
  bool Touch(uint16_t worker, bool admit) {
    if (lease_ms_ <= 0) return false;
    bool rejoined = false;
    {
      std::lock_guard<std::mutex> lk(members_mu_);
      if (worker >= member_state_.size()) return false;
      last_seen_ms_[worker] = steady_ms();
      if (member_state_[worker] != kLive && admit) {
        member_state_[worker] = kLive;
        live_workers_.fetch_add(1);
        epoch_.fetch_add(1);
        PublishMembersLocked();
        rejoined = true;
      }
    }
    if (rejoined) {
      Trace(kTrMember, worker,
            static_cast<uint32_t>(live_workers_.load()), 1, realtime_ns());
    }
    return rejoined;
  }

  // Sweep-thread eviction: every live worker silent past the lease is
  // marked dead, then open rounds / barriers / the exit gate reconcile.
  void EvictExpired() {
    std::vector<uint16_t> dead;
    {
      std::lock_guard<std::mutex> lk(members_mu_);
      const int64_t now = steady_ms();
      for (size_t w = 0; w < member_state_.size(); ++w) {
        if (member_state_[w] == kLive &&
            now - last_seen_ms_[w] > lease_ms_) {
          member_state_[w] = kEvicted;
          live_workers_.fetch_sub(1);
          epoch_.fetch_add(1);
          dead.push_back(static_cast<uint16_t>(w));
        }
      }
      if (!dead.empty()) PublishMembersLocked();
    }
    if (dead.empty()) return;
    for (uint16_t w : dead) {
      Trace(kTrMember, w,
            static_cast<uint32_t>(live_workers_.load()), 0, realtime_ns());
    }
    ReconcileAfterMembershipShrink(dead);
  }

  // A worker's clean goodbye under elastic membership: mark it DEPARTED
  // (it is no longer expected in rounds/barriers but is not an eviction)
  // and reconcile. Returns true when every worker is now accounted for
  // (departed or evicted) so the caller may stop the server.
  bool Depart(uint16_t worker) {
    if (lease_ms_ <= 0) return false;
    bool shrank = false;
    {
      std::lock_guard<std::mutex> lk(members_mu_);
      if (worker >= member_state_.size()) return false;
      if (member_state_[worker] == kLive) {
        live_workers_.fetch_sub(1);
        epoch_.fetch_add(1);
        shrank = true;
      }
      member_state_[worker] = kDeparted;
      if (shrank) PublishMembersLocked();
    }
    if (shrank) ReconcileAfterMembershipShrink({worker});
    return AllAccountedFor();
  }

  bool AllAccountedFor() {
    std::lock_guard<std::mutex> lk(members_mu_);
    int departed = 0;
    for (auto s : member_state_) departed += s == kDeparted ? 1 : 0;
    // all-evicted with zero goodbyes is treated as a transient outage
    // (workers may rejoin), not a completed job. Anonymous (legacy)
    // kShutdowns can't mark a DEPARTED slot but still count as
    // goodbyes, so a mixed fleet that all said goodbye anonymously
    // stops once the lease has evicted the silent slots.
    return live_workers_.load() <= 0 &&
           (departed > 0 || shutdown_count_.load() > 0);
  }

  // Grow every key store's per-worker vectors (arrival bitmap + replay
  // watermarks) to the current worker count. Called by Join BEFORE the
  // admission is published: the first round-completion check that sees
  // the joiner live must also see its (empty) arrival slot — otherwise a
  // RoundCompleteLocked bounded by the stale pushed.size() could close a
  // round "complete" without the joiner ever being expected in it.
  void GrowStoreSlots() {
    const size_t n = static_cast<size_t>(num_workers_.load());
    std::vector<KeyStore*> stores;
    {
      std::lock_guard<std::mutex> lk(store_mu_);
      stores.reserve(store_.size());
      for (auto& [k, ks] : store_) stores.push_back(ks.get());
    }
    for (KeyStore* ks : stores) {
      std::lock_guard<std::mutex> lk(ks->mu);
      if (ks->pushed.size() < n) {
        ks->pushed.resize(n, 0);
        ks->applied_version.resize(n, 0);
      }
    }
  }

 public:
  // Mid-stream worker ADMISSION (kJoin; scale-up elasticity). A fresh id
  // beyond the configured count GROWS the membership table and — before
  // the admission is published — every key store's per-worker vectors,
  // so the join lands at a round boundary: rounds open at admission
  // close over whoever contributed (the eviction-side quorum scaling
  // generalized upward), and every later round targets the grown live
  // set. A previously evicted/departed id re-admits exactly like the
  // kPing rejoin path (epoch bump). The joiner is expected to adopt
  // round watermarks via kRounds before its first push — under bounded
  // staleness that watermark IS the served-round frontier, which never
  // trails the force-close watermark. Returns the post-admission epoch;
  // -1 = id out of range; -2 = fixed membership (lease disabled) and the
  // id is not a configured worker.
  int64_t Join(uint16_t worker) {
    if (worker >= kMaxWorkers) return -1;
    if (lease_ms_ <= 0) {
      // fixed membership has no admission machinery: a configured id is
      // already a member (idempotent ack), a fresh one cannot be grown
      return worker < static_cast<uint16_t>(num_workers_.load())
                 ? static_cast<int64_t>(epoch_.load())
                 : -2;
    }
    {
      std::lock_guard<std::mutex> lk(members_mu_);
      if (worker >= member_state_.size()) {
        // new slots between the old count and the joiner default to
        // kEvicted: absent-but-admissible, and already accounted for by
        // the exit gate (evicted counts as accounted)
        member_state_.resize(worker + 1, kEvicted);
        last_seen_ms_.resize(worker + 1, steady_ms());
        // published BEFORE the store sweep below so any KeyStore created
        // concurrently (kInit racing the join) sizes its vectors for the
        // grown membership from the start
        num_workers_.store(static_cast<int>(member_state_.size()));
      }
    }
    GrowStoreSlots();
    bool admitted = false;
    {
      std::lock_guard<std::mutex> lk(members_mu_);
      last_seen_ms_[worker] = steady_ms();
      if (member_state_[worker] != kLive) {
        member_state_[worker] = kLive;
        live_workers_.fetch_add(1);
        epoch_.fetch_add(1);
        PublishMembersLocked();
        admitted = true;
      }
    }
    if (admitted) {
      Trace(kTrMember, worker,
            static_cast<uint32_t>(live_workers_.load()), 2, realtime_ns());
    }
    return static_cast<int64_t>(epoch_.load());
  }

 private:

  // Membership shrank: drop the dead workers' deferred (pipelined
  // next-round) pushes, close any round now complete over the live set —
  // answering its pending pulls — release barriers the dead can no
  // longer satisfy, and stop the server once every worker is departed or
  // evicted with at least one proper goodbye.
  void ReconcileAfterMembershipShrink(const std::vector<uint16_t>& dead) {
    std::vector<std::pair<uint64_t, KeyStore*>> stores;
    {
      std::lock_guard<std::mutex> lk(store_mu_);
      stores.reserve(store_.size());
      for (auto& [k, ks] : store_) stores.emplace_back(k, ks.get());
    }
    for (auto& [key, ks] : stores) {
      std::vector<ReadyResp> ready;
      {
        std::lock_guard<std::mutex> lk(ks->mu);
        auto it = ks->deferred.begin();
        while (it != ks->deferred.end()) {
          bool drop = false;
          for (uint16_t w : dead) drop = drop || it->worker == w;
          it = drop ? ks->deferred.erase(it) : it + 1;
        }
        if (!async_) {
          auto memb = Members();
          if (RoundCompleteLocked(ks, *memb)) {
            CloseRoundLocked(ks, *memb, &ready);
          }
          // a shrink can also unblock a parked bounded-staleness pull
          // (the dead worker was the missing contributor)
          ForcePendingLocked(ks, *memb, &ready);
        }
        ks->cv.notify_all();
      }
      DispatchReady(key, ks, ready);
    }
    ReleaseBarrierIfReady();
    if (AllAccountedFor()) {
      // detached: the sweep thread cannot join itself through Stop()
      std::thread([this] { Stop(); }).detach();
    }
  }

  // Barrier over the LIVE set: released as soon as the waiters cover
  // every live worker — on arrival (HandleBarrier) and again on every
  // membership shrink, so a dead worker cannot strand a barrier. Only
  // waiters that are anonymous (legacy frames) or still LIVE count
  // toward the target: a worker that barriered and then got evicted
  // must not stand in for a live peer that never arrived (its stale
  // arrival predates the membership the survivors are synchronizing).
  void ReleaseBarrierIfReady() {
    std::vector<ConnPtr> release;
    {
      std::lock_guard<std::mutex> lk(barrier_mu_);
      int target = live_workers_.load();
      if (target <= 0) target = 1;
      auto memb = Members();
      int counted = 0;
      for (auto& p : barrier_conns_) {
        const uint16_t wid1 = p.second;
        const bool anon = wid1 == 0;
        const bool live =
            !anon && static_cast<size_t>(wid1 - 1) < memb->live.size() &&
            memb->live[wid1 - 1];
        counted += (anon || live) ? 1 : 0;
      }
      if (counted > 0 && counted >= target) {
        // release EVERY waiter (stale ones included — their acks land
        // on dead conns harmlessly, and leaving them queued would leak
        // them into the next barrier round)
        release.reserve(barrier_conns_.size());
        for (auto& p : barrier_conns_) release.push_back(p.first);
        barrier_conns_.clear();
      }
    }
    for (auto& rc : release) SendFrame(rc, kAck, 0, 0, nullptr, 0);
  }

  // Response frame with an explicit reserved stamp — pull responses
  // carry the epoch their ROUND closed under (a survivor must average a
  // pre-eviction round by the pre-eviction live count, even when the
  // response is delivered after the epoch bumped).
  void SendFrameStamped(const ConnPtr& c, Cmd cmd, uint64_t key,
                        uint64_t version, const void* payload, uint32_t len,
                        uint8_t flags, uint32_t crc, uint16_t reserved) {
    std::lock_guard<std::mutex> lk(c->send_mu);
    if (c->closed) return;  // peer went away; response is moot
    send_frame(c->fd, cmd, key, version, payload, len, flags, reserved,
               crc);
  }

  void SendFrame(const ConnPtr& c, Cmd cmd, uint64_t key, uint64_t version,
                 const void* payload, uint32_t len, uint8_t flags = 0,
                 uint32_t crc = 0) {
    // every response carries the CURRENT membership epoch (low 16 bits):
    // workers learn of evictions/rejoins on their next op, no extra
    // round trip
    SendFrameStamped(
        c, cmd, key, version, payload, len, flags, crc,
        static_cast<uint16_t>(epoch_.load(std::memory_order_relaxed)));
  }

  void SendErr(const ConnPtr& c, uint64_t key, const char* msg) {
    SendFrame(c, kErr, key, 0, msg, static_cast<uint32_t>(std::strlen(msg)));
  }

  KeyStore* GetOrCreate(uint64_t key, size_t nfloats) {
    std::lock_guard<std::mutex> lk(store_mu_);
    auto& slot = store_[key];
    if (!slot) {
      slot = std::make_unique<KeyStore>();
      slot->n_elems = nfloats;
      slot->accum.assign(nfloats, 0.f);
      slot->result = std::make_shared<const FloatBuf>(nfloats, 0.f);
      slot->pushed.assign(num_workers_, 0);
      slot->applied_version.assign(num_workers_, 0);
    }
    return slot.get();
  }

  KeyStore* Get(uint64_t key) {
    std::lock_guard<std::mutex> lk(store_mu_);
    auto it = store_.find(key);
    return it == store_.end() ? nullptr : it->second.get();
  }

  // A pull whose round is ready, with the (version, snapshot, codec hint)
  // captured under ks->mu AT THE MOMENT the round closed — a later round
  // closing before the response is sent must not substitute its own sum
  // or its own encoding parameters.
  struct ReadyResp {
    ConnPtr conn;
    uint8_t codec;
    bool want_crc;
    uint64_t version;
    std::shared_ptr<const FloatBuf> snap;
    CodecHint hint;
    uint64_t epoch;  // membership epoch the round CLOSED under
  };

  // ---- bounded staleness (BYTEPS_STALENESS=K, sync mode) ------------------
  // A pull for round v may be served from any CLOSED round >= v-K; the
  // oldest legal serve is also the round the pull may FORCE-close up to
  // when the straggler holds it open past the bound. The first K rounds
  // (v <= K) never force: the job starts with one naturally-closed
  // round, so the ladder's base is a real quorum sum, not served zeros.
  uint64_t ServeMin(uint64_t version) const {
    if (async_ || staleness_ <= 0) return version;
    const uint64_t k = static_cast<uint64_t>(staleness_);
    return version > k ? version - k : 1;
  }

  uint64_t ForceMin(uint64_t version) const {
    if (async_ || staleness_ <= 0) return 0;
    const uint64_t k = static_cast<uint64_t>(staleness_);
    return version > k ? version - k : 0;
  }

  // Close open rounds up to `target` over whoever contributed (the
  // eviction-analog: each close quorum-scales the partial sum to the
  // live count, so the global average stays unbiased). Stops at an
  // EMPTY open round — a round nobody joined yet cannot close, and the
  // parked pull waits for the next push apply to re-trigger.
  void ForceAdvanceLocked(KeyStore* ks, const Membership& memb,
                          uint64_t target,
                          std::vector<ReadyResp>* ready) {
    while (ks->version < target && ks->arrived > 0) {
      CloseRoundLocked(ks, memb, ready);
    }
  }

  // Re-check every parked pull's force bound after a push apply: the
  // push that just landed may be the contribution that lets a blocked
  // fast worker's round ladder advance.
  void ForcePendingLocked(KeyStore* ks, const Membership& memb,
                          std::vector<ReadyResp>* ready) {
    if (async_ || staleness_ <= 0 || ks->pending.empty()) return;
    uint64_t target = 0;
    for (const auto& p : ks->pending) {
      target = std::max(target, p.force_min);
    }
    if (target > ks->version) ForceAdvanceLocked(ks, memb, target, ready);
  }

  // Round completion over the LIVE membership: closed when every live
  // worker contributed. Contributions from workers evicted mid-round may
  // already sit in accum — the close-time quorum scaling handles them.
  // Never closes an empty round: accum is uninitialized until the first
  // push of the round lands.
  bool RoundCompleteLocked(KeyStore* ks, const Membership& m) {
    if (m.count == 0 || ks->arrived == 0) return false;
    for (size_t w = 0; w < m.live.size() && w < ks->pushed.size(); ++w) {
      if (m.live[w] && !ks->pushed[w]) return false;
    }
    return true;
  }

  // Close the open round: snapshot by MOVE, fresh accumulator, answer the
  // pulls this round satisfies, then re-apply deferred next-round pushes.
  void CloseRoundLocked(KeyStore* ks, const Membership& memb,
                        std::vector<ReadyResp>* ready) {
    // Quorum scaling: a worker evicted mid-round may have contributed to
    // accum (contributors > live), and a bounded-staleness FORCE-close
    // fires before every live worker arrived (contributors < live) —
    // either way the pullers will average this sum over the LIVE count
    // (the membership their epoch adoption reports), so scale the sum by
    // live/contributors to keep the global *average* unbiased. A clean
    // round (contributors == live) takes no multiply at all — healthy
    // epochs (and the whole K=0 ladder) stay bit-exact.
    if (memb.count > 0 && ks->arrived > 0 && ks->arrived != memb.count) {
      const float s = static_cast<float>(memb.count) /
                      static_cast<float>(ks->arrived);
      for (auto& v : ks->accum) v *= s;
    }
    // the codec hint is frozen with the result so deferred next-round
    // pushes below cannot change how THIS round's responses are encoded
    auto snap = std::make_shared<FloatBuf>(std::move(ks->accum));
    // moved-from accum is empty; resize on the no-init allocator
    // allocates WITHOUT the 4 MB zero-fill (the next round's first
    // push overwrites or zero+sums — ApplyPushLocked's start-of-round
    // branch)
    ks->accum.resize(snap->size());
    ks->result = std::move(snap);
    ks->result_hint = ks->hint;
    ks->result_epoch = memb.epoch;
    ks->version++;
    ks->arrived = 0;
    std::fill(ks->pushed.begin(), ks->pushed.end(), 0);
    ks->cache_codec = 0xFF;
    ks->cv.notify_all();
    // hand this round's snapshot to the pulls it satisfies BEFORE
    // applying deferred pushes (which may immediately close the next
    // round and overwrite ks->result)
    auto it = ks->pending.begin();
    while (it != ks->pending.end()) {
      if (ks->version >= it->version) {
        ready->push_back({it->conn, it->codec, it->want_crc, ks->version,
                          ks->result, ks->result_hint, ks->result_epoch});
        it = ks->pending.erase(it);
      } else {
        ++it;
      }
    }
    auto deferred = std::move(ks->deferred);
    ks->deferred.clear();
    for (auto& d : deferred) {
      ApplyPushLocked(ks, memb, d.worker, d.codec, d.version,
                      std::move(d.buf), ready);
    }
  }

  // Decode+sum one arrived push under ks->mu. A worker that pushes round
  // v+1 before round v closed (pipelined pushes are legal — the ack no
  // longer waits for the sum) is deferred and re-applied at round close.
  // Pulls satisfied by a closing round are appended to `ready` with that
  // round's snapshot. `version` != 0 arms replay dedupe: a (worker,
  // version) at or below the already-applied watermark — or already
  // sitting in the deferred queue — is a retry-engine re-send whose
  // original landed, and is dropped instead of double-summed. `memb` is
  // the live membership the round targets (snapshotted under ks->mu, so
  // an eviction either lands before this push — visible here — or its
  // reconcile sweep sees this contribution; a completable round can
  // never be missed between the two).
  void ApplyPushLocked(KeyStore* ks, const Membership& memb,
                       uint16_t worker, uint8_t codec, uint64_t version,
                       std::shared_ptr<RawBuf> buf,
                       std::vector<ReadyResp>* ready) {
    const int64_t n = static_cast<int64_t>(ks->n_elems);
    if (version != 0 && worker < ks->applied_version.size() &&
        version <= ks->applied_version[worker]) {
      return;  // duplicate of an already-summed push
    }
    if (staleness_ > 0 && !async_ && version != 0 &&
        version <= ks->version) {
      // Bounded staleness: the round this push belongs to already closed
      // over its contributors (a fast worker's pull force-closed it) —
      // a straggler's late push is EXPECTED and consumed silently, never
      // an error. The applied watermark still advances so a retry
      // engine's replay of this same round dedupes as before, and the
      // straggler's next pull serves it the newest closed round to
      // catch up from.
      if (worker < ks->applied_version.size()) {
        ks->applied_version[worker] = version;
      }
      return;
    }
    if (lease_ms_ > 0 && !async_ && version != 0 &&
        version <= ks->version) {
      // Stale round, re-checked ATOMICALLY with the round state: the
      // kPush handler's pre-ack guard races the eviction sweep (the
      // round can close between the check and this apply), and a round
      // that closed without this worker must never have the worker's
      // payload credited to the NEXT round. Dropped silently (the ack
      // already went out); the worker learns via the epoch stamp / its
      // next push's kErr and rejoins.
      return;
    }
    if (!async_ && ks->pushed[worker]) {
      if (version != 0) {
        for (const auto& d : ks->deferred) {
          if (d.worker == worker && d.version == version) {
            return;  // duplicate of a push already queued for next round
          }
        }
      }
      ks->deferred.push_back({worker, codec, version, std::move(buf)});
      return;
    }
    if (version != 0 && worker < ks->applied_version.size()) {
      ks->applied_version[worker] = version;
    }
    if (!async_ && ks->arrived == 0) {
      // Start of a round: accum is UNINITIALIZED (the close path moves it
      // into the snapshot and reallocates without a zero-fill). A raw
      // push OVERWRITES it in one pass — memcpy instead of
      // zero + read-modify-write saves two full memory sweeps per round
      // on the engine's critical path; every other codec zero-fills
      // first, then sums as before.
      if (codec == kCodecRaw &&
          buf->size() == static_cast<size_t>(n) * sizeof(float)) {
        std::memcpy(ks->accum.data(), buf->data(), buf->size());
      } else {
        std::fill(ks->accum.begin(), ks->accum.end(), 0.f);
        decode_sum(codec, buf->data(), buf->size(), ks->accum.data(), n);
      }
    } else {
      decode_sum(codec, buf->data(), buf->size(), ks->accum.data(), n);
    }
    update_hint(codec, buf->data(), buf->size(), &ks->hint);
    if (async_) {
      ks->version++;
      ks->cv.notify_all();
      return;
    }
    ks->pushed[worker] = 1;
    ++ks->arrived;
    if (RoundCompleteLocked(ks, memb)) {
      CloseRoundLocked(ks, memb, ready);
    }
  }

  void DispatchReady(uint64_t key, KeyStore* ks,
                     std::vector<ReadyResp>& ready) {
    for (auto& p : ready) {
      // parallel fan-out: each response encodes+sends on its own engine slot
      SubmitEngine(key, [this, ks, key, p = std::move(p)] {
        RespondPull(p.conn, key, ks, p.codec, p.want_crc, p.version, p.snap,
                    p.hint, p.epoch);
      });
    }
  }

  void ApplyPush(KeyStore* ks, uint64_t key, uint16_t worker, uint8_t codec,
                 uint64_t version, std::shared_ptr<RawBuf> buf) {
    const int64_t t0 = realtime_ns();
    const uint32_t len = static_cast<uint32_t>(buf->size());
    std::vector<ReadyResp> ready;
    {
      std::lock_guard<std::mutex> lk(ks->mu);
      auto memb = Members();
      ApplyPushLocked(ks, *memb, worker, codec, version, std::move(buf),
                      &ready);
      // bounded staleness: this push may be the contribution a parked
      // fast-worker pull was waiting on — re-check the force bounds of
      // every pending pull, and wake in-process (LocalPull) waiters so
      // they re-evaluate their own bound
      ForcePendingLocked(ks, *memb, &ready);
      if (staleness_ > 0 && !async_) ks->cv.notify_all();
      if (async_) {
        auto it = ks->pending.begin();
        while (it != ks->pending.end()) {
          ready.push_back(
              {it->conn, it->codec, it->want_crc, ks->version,
               std::make_shared<const FloatBuf>(ks->accum),
               ks->hint, memb->epoch});
          it = ks->pending.erase(it);
        }
      }
    }
    Trace(kTrSum, key, len, codec, t0);
    DispatchReady(key, ks, ready);
  }

  // Encode the round result for one pull. Cached per (version, codec) so a
  // round's W pulls cost one re-compression, not W; cache hits share the
  // immutable blob (zero-copy into SendFrame). `hint` is the codec hint
  // snapshotted when `snap`'s round closed, NOT the live ks->hint.
  std::shared_ptr<const std::vector<char>> EncodeResponse(
      KeyStore* ks, const std::shared_ptr<const FloatBuf>& snap,
      const CodecHint& hint, uint64_t version, uint8_t codec) {
    {
      std::lock_guard<std::mutex> lk(ks->mu);
      if (!async_ && ks->cache_version == version &&
          ks->cache_codec == codec && ks->cache_blob) {
        return ks->cache_blob;
      }
    }
    // deterministic stochastic-rounding seed per round
    auto blob = std::make_shared<const std::vector<char>>(
        encode(codec, snap->data(), static_cast<int64_t>(snap->size()),
               hint, version * 0x9E3779B97F4A7C15ull + 12345));
    if (!async_) {
      std::lock_guard<std::mutex> lk(ks->mu);
      ks->cache_version = version;
      ks->cache_codec = codec;
      ks->cache_blob = blob;
    }
    return blob;
  }

  // `epoch` = membership epoch the round closed under; stamped into the
  // response header so the puller averages by the round's OWN live count
  // (not the possibly-newer current membership).
  void RespondPull(const ConnPtr& c, uint64_t key, KeyStore* ks,
                   uint8_t codec, bool want_crc, uint64_t version,
                   std::shared_ptr<const FloatBuf> snap,
                   const CodecHint& hint, uint64_t epoch) {
    const int64_t t0 = realtime_ns();
    const uint16_t stamp = static_cast<uint16_t>(epoch);
    if (codec == kCodecRaw) {
      // zero-copy from the immutable snapshot
      const uint32_t len =
          static_cast<uint32_t>(snap->size() * sizeof(float));
      const uint32_t crc = want_crc ? wire_crc(snap->data(), len) : 0;
      SendFrameStamped(c, kResp, key, version, snap->data(), len,
                       kCodecRaw, crc, stamp);
      Trace(kTrPullResp, key, len, kCodecRaw, t0);
      return;
    }
    auto blob = EncodeResponse(ks, snap, hint, version, codec);
    const uint32_t crc =
        want_crc ? wire_crc(blob->data(), blob->size()) : 0;
    SendFrameStamped(c, kResp, key, version, blob->data(),
                     static_cast<uint32_t>(blob->size()), codec, crc,
                     stamp);
    Trace(kTrPullResp, key, static_cast<uint32_t>(blob->size()), codec, t0);
  }

  void HandlePull(const ConnPtr& c, uint64_t key, uint64_t version,
                  uint8_t codec, bool want_crc) {
    KeyStore* ks = Get(key);
    if (ks == nullptr) {
      SendErr(c, key, "pull before init");
      return;
    }
    bool ready;
    uint64_t v = 0;
    uint64_t epoch = 0;
    std::shared_ptr<const FloatBuf> snap;
    CodecHint hint;
    // bounded staleness: serve the NEWEST closed round as long as it is
    // within K of the requested one; a pull past the bound force-closes
    // the straggler-held rounds up to version-K (quorum-scaled over
    // their contributors) instead of parking forever behind it
    const uint64_t serve_min = ServeMin(version);
    const uint64_t force_min = ForceMin(version);
    std::vector<ReadyResp> released;
    {
      std::lock_guard<std::mutex> lk(ks->mu);
      if (force_min > ks->version) {
        auto memb = Members();
        ForceAdvanceLocked(ks, *memb, force_min, &released);
      }
      ready = async_ ? ks->version > 0 : ks->version >= serve_min;
      if (!ready) {
        ks->pending.push_back(
            {c, serve_min, codec, want_crc, steady_ms(), force_min});
      } else {
        v = ks->version;
        if (async_) {
          snap = std::make_shared<const FloatBuf>(ks->accum);
          hint = ks->hint;
          epoch = epoch_.load();
        } else {
          snap = ks->result;
          hint = ks->result_hint;
          epoch = ks->result_epoch;
        }
      }
    }
    // pulls from OTHER workers satisfied by the force-close
    DispatchReady(key, ks, released);
    if (ready) {
      SubmitEngine(key, [this, c, key, ks, codec, want_crc, v, hint, epoch,
                         snap = std::move(snap)] {
        RespondPull(c, key, ks, codec, want_crc, v, snap, hint, epoch);
      });
    }
  }

  void HandleBarrier(const ConnPtr& c, uint16_t reserved) {
    if (reserved > 0) Touch(static_cast<uint16_t>(reserved - 1), false);
    {
      std::lock_guard<std::mutex> lk(barrier_mu_);
      barrier_conns_.emplace_back(c, reserved);
    }
    ReleaseBarrierIfReady();
  }

  // Expire pulls stuck past the deadline (a dead worker otherwise leaves
  // its peers blocked forever — reference failure story: ps-lite
  // heartbeat) and, with the lease armed, evict workers whose lease
  // expired. The tick shortens with the lease so eviction latency stays
  // a small multiple of BYTEPS_WORKER_LEASE_MS.
  void SweepLoop() {
    const int tick_ms =
        lease_ms_ > 0 ? std::max(20, std::min(200, lease_ms_ / 4)) : 200;
    while (running_) {
      std::this_thread::sleep_for(std::chrono::milliseconds(tick_ms));
      if (!running_) break;
      if (lease_ms_ > 0) EvictExpired();
      if (pull_timeout_ms_ <= 0) continue;
      const int64_t now = steady_ms();
      std::vector<std::pair<uint64_t, KeyStore*>> stores;
      {
        std::lock_guard<std::mutex> lk(store_mu_);
        stores.reserve(store_.size());
        for (auto& [k, ks] : store_) stores.emplace_back(k, ks.get());
      }
      std::vector<std::pair<ConnPtr, uint64_t>> expired;  // (conn, key)
      for (auto& [key, ks] : stores) {
        std::lock_guard<std::mutex> lk(ks->mu);
        auto it = ks->pending.begin();
        while (it != ks->pending.end()) {
          if (now - it->enq_ms > pull_timeout_ms_) {
            expired.emplace_back(it->conn, key);
            it = ks->pending.erase(it);
          } else {
            ++it;
          }
        }
      }
      for (auto& [c, key] : expired) {
        SendErr(c, key, "pull timeout: a worker likely died");
      }
    }
  }

  void ConnLoop(const ConnPtr& c) {
    FrameHeader h;
    bool stop_server_after = false;
    while (running_ && recv_all(c->fd, &h, sizeof(h))) {
      if (h.magic != kMagic || h.len > kMaxFrameLen) break;
      const int64_t t_recv = realtime_ns();
      auto payload = std::make_shared<RawBuf>();
      if (h.len > 0) {
        payload->resize(h.len);
        if (!recv_all(c->fd, payload->data(), h.len)) break;
      }
      bool done = false;
      switch (h.cmd) {
        case kInit: {
          if (h.version == 0 || h.version > kMaxFrameLen ||
              h.version % 4 != 0) {
            SendErr(c, h.key, "bad init size");
            break;
          }
          KeyStore* ks = GetOrCreate(h.key, h.version / sizeof(float));
          if (ks->n_elems * sizeof(float) != h.version) {
            // mismatched partition config across pods — fail loudly
            // instead of letting a later push corrupt the store
            SendErr(c, h.key, "init size mismatch");
          } else {
            SendFrame(c, kAck, h.key, 0, nullptr, 0);
          }
          break;
        }
        case kPush: {
          KeyStore* ks = Get(h.key);
          if (ks == nullptr) {
            SendErr(c, h.key, "push before init");
            break;
          }
          // validated in ASYNC mode too: an out-of-range or evicted
          // worker must not silently sum into the free-running
          // aggregate (and its Touch below keeps kMembers truthful)
          if (h.reserved >= num_workers_) {
            SendErr(c, h.key, "worker id out of range");
            break;
          }
          if (!WorkerLive(h.reserved)) {
            // an evicted worker's stale round must not leak into the
            // post-eviction sums; it rejoins first (kPing heartbeat +
            // kRounds watermark adoption) and re-sends under the new
            // epoch (the worker-side WorkerEvictedError path)
            SendErr(c, h.key, "worker evicted: rejoin required");
            break;
          }
          if (!async_ && staleness_ <= 0 && lease_ms_ > 0 &&
              h.version != 0) {
            // Stale-round guard (strict-sync only — under bounded
            // staleness a late round is EXPECTED and consumed silently
            // by ApplyPushLocked, never a rejoin-forcing error): a
            // worker evicted MID-ROUND whose
            // heartbeat already re-admitted it (monitor rejoin after a
            // wedge) may still re-send the round it was evicted out of.
            // That round CLOSED without it — summing the payload now
            // would credit a stale gradient to the currently open
            // round. Detectably stale: version at/below the key's
            // closed-round watermark yet above the worker's applied
            // watermark (a true replay is at/below applied and is
            // dedupe-dropped as before). Reject like an eviction so the
            // worker rejoins, adopts watermarks, and re-mints.
            bool stale;
            {
              std::lock_guard<std::mutex> lk(ks->mu);
              stale = h.version <= ks->version &&
                      h.reserved < ks->applied_version.size() &&
                      h.version > ks->applied_version[h.reserved];
            }
            if (stale) {
              SendErr(c, h.key,
                      "worker evicted mid-round (stale round): rejoin "
                      "required");
              break;
            }
          }
          Touch(h.reserved, /*admit=*/false);
          if (!validate_payload(h.flags, payload->data(), h.len,
                                static_cast<int64_t>(ks->n_elems))) {
            SendErr(c, h.key, "payload does not match store size");
            break;
          }
          if (h.crc != 0 &&
              wire_crc(payload->data(), payload->size()) != h.crc) {
            // corrupted in transit — detected, NOT applied; the worker
            // retry engine treats this kErr as retryable and re-sends
            SendErr(c, h.key, "payload crc mismatch");
            break;
          }
          // ack on receipt — the pull's version gate provides the round
          // barrier, so the worker can pipeline its next push while the
          // engine sums this one. Applications are ordered per
          // (key, worker) strand: pipelined same-key pushes land in
          // receive order (even across a reconnect) while distinct keys
          // fan out across the pool.
          SendFrame(c, kAck, h.key, 0, nullptr, 0);
          Trace(kTrPushRecv, h.key, h.len, h.flags, t_recv);
          const uint16_t worker = h.reserved;
          const uint8_t codec = h.flags;
          PostOrdered(ks, h.key, worker,
                      [this, ks, key = h.key, worker, codec,
                       version = h.version,
                       buf = std::move(payload)]() mutable {
                        ApplyPush(ks, key, worker, codec, version,
                                  std::move(buf));
                      });
          break;
        }
        case kPull:
          if (h.reserved > 0) {
            Touch(static_cast<uint16_t>(h.reserved - 1), /*admit=*/false);
          }
          HandlePull(c, h.key, h.version, h.flags, h.crc != 0);
          break;
        case kBarrier:
          HandleBarrier(c, h.reserved);
          break;
        case kPing:
          // reserved = worker_id + 1 turns the clock probe into the
          // worker's lease heartbeat — and the REJOIN signal: an evicted
          // worker's heartbeat re-admits it (epoch bumps; the worker then
          // adopts round watermarks via kRounds before pushing again)
          if (h.reserved > 0 && h.reserved - 1 < num_workers_) {
            Touch(static_cast<uint16_t>(h.reserved - 1), /*admit=*/true);
          }
          SendFrame(c, kAck, h.key,
                    static_cast<uint64_t>(realtime_ns()), nullptr, 0);
          break;
        case kMembers: {
          auto m = Members();
          std::vector<char> pay(8 + m->live.size());
          const uint32_t live = m->count;
          const uint32_t nw = static_cast<uint32_t>(m->live.size());
          std::memcpy(pay.data(), &live, 4);
          std::memcpy(pay.data() + 4, &nw, 4);
          if (!m->live.empty()) {
            std::memcpy(pay.data() + 8, m->live.data(), m->live.size());
          }
          // version = the SNAPSHOT's epoch (see MembersInfo): the live
          // set and its epoch label must come from one atomic view
          SendFrame(c, kResp, h.key, m->epoch, pay.data(),
                    static_cast<uint32_t>(pay.size()));
          break;
        }
        case kRounds: {
          // per-key round watermarks for the rejoin handshake: a
          // restarted/evicted worker adopts these so its next mint
          // continues the server's round sequence (a fresh counter would
          // mint versions at/below the replay-dedupe watermark and every
          // later round would be dropped as a replay)
          std::vector<std::pair<uint64_t, KeyStore*>> stores;
          {
            std::lock_guard<std::mutex> lk(store_mu_);
            stores.reserve(store_.size());
            for (auto& [k, ks] : store_) stores.emplace_back(k, ks.get());
          }
          std::vector<char> pay;
          pay.reserve(stores.size() * 24);
          for (auto& [k, ks] : stores) {
            uint64_t trip[3];
            trip[0] = k;
            {
              std::lock_guard<std::mutex> lk(ks->mu);
              trip[1] = ks->version;
              trip[2] = static_cast<uint64_t>(ks->n_elems) * 4;
            }
            const char* p = reinterpret_cast<const char*>(trip);
            pay.insert(pay.end(), p, p + sizeof(trip));
          }
          SendFrame(c, kResp, h.key, epoch_.load(), pay.data(),
                    static_cast<uint32_t>(pay.size()));
          break;
        }
        case kJoin: {
          // first-class mid-stream admission (scale-up elasticity): the
          // tail of the worker lease/epoch machinery — see Join()
          if (h.reserved == 0) {
            SendErr(c, h.key, "join needs a worker id");
            break;
          }
          const int64_t ep = Join(static_cast<uint16_t>(h.reserved - 1));
          if (ep == -1) {
            SendErr(c, h.key, "join: worker id out of range");
          } else if (ep == -2) {
            SendErr(c, h.key,
                    "join: fixed membership (lease disabled) cannot admit "
                    "a new worker id");
          } else {
            SendFrame(c, kAck, h.key, static_cast<uint64_t>(ep), nullptr,
                      0);
          }
          break;
        }
        case kShutdown: {
          SendFrame(c, kAck, 0, 0, nullptr, 0);
          int count = ++shutdown_count_;
          if (lease_ms_ <= 0) {
            // legacy gate: every configured worker said goodbye. Only
            // without the lease — a raw frame COUNT is wrong under
            // elastic membership, where one worker id can legitimately
            // say goodbye twice (depart → replacement rejoins → depart)
            // while a peer is still training.
            if (count >= num_workers_) stop_server_after = true;
          } else if (h.reserved > 0 && h.reserved - 1 < num_workers_) {
            // elastic gate: an identified goodbye marks the worker
            // DEPARTED; the server exits once every worker is departed
            // or evicted — a dead worker cannot hold up teardown, and a
            // live one cannot be stranded by double goodbyes
            if (Depart(static_cast<uint16_t>(h.reserved - 1))) {
              stop_server_after = true;
            }
          } else if (AllAccountedFor()) {
            // anonymous goodbye under the lease: counted (see
            // AllAccountedFor) but cannot name its slot — the lease
            // sweep evicts it and the exit gate re-checks there
            stop_server_after = true;
          }
          done = true;
          break;
        }
        default:
          SendErr(c, h.key, "bad cmd");
          break;
      }
      if (done) break;
    }
    // per-connection teardown: long-running servers with reconnecting
    // workers must not accrete dead Conn entries or leak fds until Stop
    {
      std::lock_guard<std::mutex> lk(conn_mu_);
      conns_.erase(c->id);
    }
    CloseConn(c);
    if (stop_server_after) {
      std::thread([this] { Stop(); }).detach();
    }
  }

  int listen_fd_ = -1;
  // atomic: read lock-free on every conn thread's bounds checks, GROWN
  // by a mid-stream kJoin admitting a fresh worker id
  std::atomic<int> num_workers_{1};
  bool async_ = false;
  bool schedule_ = false;
  int pull_timeout_ms_ = 0;
  int server_id_ = 0;
  int lease_ms_ = 0;
  int staleness_ = 0;  // bounded-staleness K (0 = strict sync rounds)
  // elastic membership (see the helper block above): per-worker lease +
  // state under members_mu_; live count and epoch are atomics so the
  // data plane (SendFrame's epoch stamp, barrier targets) reads them
  // without taking the membership lock
  std::mutex members_mu_;
  std::vector<uint8_t> member_state_;  // MemberState, indexed by worker id
  std::vector<int64_t> last_seen_ms_;  // steady clock, guarded by members_mu_
  std::atomic<int> live_workers_{1};
  std::atomic<uint64_t> epoch_{0};
  // immutable snapshot for lock-free data-plane reads (see Members())
  std::shared_ptr<const Membership> members_snap_ =
      std::make_shared<const Membership>();
  std::atomic<bool> running_{false};
  std::atomic<int> shutdown_count_{0};
  std::unique_ptr<ThreadPool> engine_;
  std::thread accept_thread_;
  std::thread sweep_thread_;
  std::mutex threads_mu_;
  std::condition_variable threads_cv_;
  int live_conn_threads_ = 0;  // guarded by threads_mu_
  std::mutex conn_mu_;
  uint64_t next_conn_id_ = 1;
  std::unordered_map<uint64_t, ConnPtr> conns_;
  std::mutex store_mu_;
  std::unordered_map<uint64_t, std::unique_ptr<KeyStore>> store_;
  std::mutex barrier_mu_;
  // (conn, worker_id + 1) — 0 = anonymous legacy frame; identity lets
  // the release target ignore waiters evicted while queued
  std::vector<std::pair<ConnPtr, uint16_t>> barrier_conns_;
  std::mutex stop_mu_;
  std::mutex done_mu_;
  std::condition_variable done_cv_;
  std::atomic<bool> trace_on_{false};
  std::mutex trace_mu_;
  std::vector<TraceEv> trace_;
};

Server* g_server = nullptr;
// Stopped servers are RETIRED, never deleted: a thread can still hold the
// pointer it got from GetServer() (e.g. blocked in LocalPull's cv wait up
// to its timeout) when a restart reclaims the singleton slot — deleting
// would destroy mutexes/cvs under a waiter (UB). The leak is bounded by
// the number of in-process restarts, which is ~0 outside tests.
std::vector<Server*> g_retired;
std::mutex g_server_mu;

Server* GetServer() {
  std::lock_guard<std::mutex> lk(g_server_mu);
  return g_server;
}

}  // namespace

int StartServer(uint16_t port, int num_workers, int engine_threads,
                bool async, int pull_timeout_ms, int server_id,
                bool schedule, int lease_ms, int staleness) {
  std::lock_guard<std::mutex> lk(g_server_mu);
  if (g_server != nullptr) {
    if (g_server->IsRunning()) return -10;  // already running
    // worker-driven shutdown stopped it but left the pointer; retire it so
    // a fresh server can start in this process
    g_server->Stop();  // idempotent; joins any remaining teardown
    g_retired.push_back(g_server);
    g_server = nullptr;
  }
  auto* s = new Server();
  int rc = s->Start(port, num_workers, engine_threads, async,
                    pull_timeout_ms, server_id, schedule, lease_ms,
                    staleness);
  if (rc != 0) {
    delete s;  // never published: no other thread can hold it
    return rc;
  }
  g_server = s;
  return 0;
}

void WaitServer() {
  Server* s = GetServer();
  if (s != nullptr) s->Wait();
}

void StopServer() {
  Server* s;
  {
    std::lock_guard<std::mutex> lk(g_server_mu);
    s = g_server;
    g_server = nullptr;
  }
  if (s != nullptr) {
    s->Stop();
    std::lock_guard<std::mutex> lk(g_server_mu);
    g_retired.push_back(s);  // see g_retired: concurrent holders may remain
  }
}

void ServerTraceEnable(bool on) {
  Server* s = GetServer();
  if (s != nullptr) s->TraceEnable(on);
}

uint64_t ServerEpoch() {
  Server* s = GetServer();
  return s != nullptr ? s->Epoch() : 0;
}

int ServerMembers(uint64_t* epoch, uint32_t* live_count, uint8_t* bitmap,
                  uint32_t cap) {
  Server* s = GetServer();
  if (s == nullptr) return -10;
  return s->MembersInfo(epoch, live_count, bitmap, cap);
}

int64_t ServerJoin(uint16_t worker) {
  Server* s = GetServer();
  if (s == nullptr) return -10;
  return s->Join(worker);
}

int ServerTraceDump(const char* path) {
  Server* s = GetServer();
  if (s == nullptr) {
    // trace of the most recently retired server (dump-after-shutdown)
    std::lock_guard<std::mutex> lk(g_server_mu);
    if (g_retired.empty()) return -2;
    s = g_retired.back();
  }
  return s->TraceDump(path);
}

int LocalInit(uint64_t key, uint64_t nbytes) {
  Server* s = GetServer();
  return s != nullptr ? s->LocalInit(key, nbytes) : -10;
}

int LocalPush(uint16_t worker, uint64_t key, uint8_t codec,
              uint64_t version, const char* buf, size_t len) {
  Server* s = GetServer();
  return s != nullptr ? s->LocalPush(worker, key, codec, version, buf, len)
                      : -10;
}

int LocalPull(uint64_t key, uint8_t codec, uint64_t version, int timeout_ms,
              std::vector<char>* out, uint64_t* out_epoch,
              uint64_t* out_version) {
  Server* s = GetServer();
  return s != nullptr
             ? s->LocalPull(key, codec, version, timeout_ms, out, out_epoch,
                            out_version)
             : -10;
}

}  // namespace bps
