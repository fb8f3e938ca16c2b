#include "client.h"

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <netdb.h>

#include "common.h"

namespace bps {

namespace {
int ConnectOnce(const std::string& host, uint16_t port, const char** why) {
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  int grc = ::getaddrinfo(host.c_str(), std::to_string(port).c_str(), &hints,
                          &res);
  if (grc != 0) {
    *why = ::gai_strerror(grc);
    return -1;
  }
  int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0) {
    *why = ::strerror(errno);
  } else if (::connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
    *why = ::strerror(errno);
    ::close(fd);
    fd = -1;
  }
  ::freeaddrinfo(res);
  return fd;
}

int64_t steady_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}
}  // namespace

Client::~Client() {
  if (fd_ >= 0) ::close(fd_);
}

int Client::Connect(const std::string& host, uint16_t port, int timeout_ms,
                    int recv_timeout_ms) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  const char* why = "unknown";
  for (;;) {
    int fd = ConnectOnce(host, port, &why);
    if (fd >= 0) {
      set_nodelay(fd);
      set_bufsizes(fd);
      set_recv_timeout(fd, recv_timeout_ms);
      fd_ = fd;
      return 0;
    }
    if (std::chrono::steady_clock::now() >= deadline) {
      // surfaced via stderr because there is no client handle yet for
      // last_error(); "refused for the whole budget while the port looks
      // bound" has meant a dead accept loop before — name the errno so
      // the next person doesn't have to strace a flake
      std::fprintf(stderr, "bps client: connect %s:%u gave up after %d ms"
                   " (last error: %s)\n", host.c_str(), port, timeout_ms,
                   why);
      return -1;
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
}

void Client::Kill() {
  if (fd_ >= 0) {
    ::close(fd_);
    fd_ = -1;
  }
}

// Serial request → response. Negative on transport error, positive on
// server kErr (message in last_err), 0 ok. `in`/`in_cap` receive a kResp
// payload; *got gets the actual size. kAck payloads are drained; a
// too-large kResp is drained too, keeping the stream framed (-5). Every
// server response echoes the request key, which is verified here — a
// mismatch means the stream carries a stale frame (e.g. a late response
// after a timeout) and the connection is closed rather than trusted.
int Client::Roundtrip(Cmd cmd, uint64_t key, uint64_t version,
                      const void* req, uint32_t req_len, void* in,
                      uint64_t in_cap, uint64_t* got, uint8_t flags,
                      uint16_t reserved, uint64_t* resp_version,
                      uint32_t req_crc, uint32_t* resp_crc,
                      uint16_t* resp_reserved) {
  if (fd_ < 0) return -2;
  if (!send_frame(fd_, cmd, key, version, req, req_len, flags, reserved,
                  req_crc)) {
    Kill();
    return -2;
  }
  FrameHeader h;
  if (!recv_all(fd_, &h, sizeof(h))) {
    int rc = (errno == EAGAIN || errno == EWOULDBLOCK) ? -7 : -3;
    Kill();
    return rc;
  }
  if (h.magic != kMagic) {
    Kill();
    return -4;
  }
  if (h.key != key) {
    // stale frame from a previous (timed-out) request, or a server bug —
    // either way the stream can no longer be trusted
    Kill();
    return -6;
  }
  // every server response stamps a membership epoch into reserved (pull
  // responses: the epoch their ROUND closed under; everything else: the
  // current epoch); remember it so the owner can detect evictions and
  // rejoins per op
  epoch_.store(h.reserved, std::memory_order_relaxed);
  if (resp_reserved != nullptr) *resp_reserved = h.reserved;
  if (h.cmd == kErr) {
    std::vector<char> msg(h.len);
    if (h.len > 0 && !recv_all(fd_, msg.data(), h.len)) {
      Kill();
      return -3;
    }
    last_err_.assign(msg.begin(), msg.end());
    return 1;
  }
  if (resp_version != nullptr) *resp_version = h.version;
  if (resp_crc != nullptr) *resp_crc = h.crc;
  if (h.cmd == kResp) {
    if (in == nullptr || h.len > in_cap) {
      if (!drain_bytes(fd_, h.len)) {
        Kill();
        return -3;
      }
      return -5;
    }
    if (h.len > 0 && !recv_all(fd_, in, h.len)) {
      int rc = (errno == EAGAIN || errno == EWOULDBLOCK) ? -7 : -3;
      Kill();
      return rc;
    }
    if (got != nullptr) *got = h.len;
    return 0;
  }
  // kAck
  if (h.len > 0 && !drain_bytes(fd_, h.len)) {
    Kill();
    return -3;
  }
  return 0;
}

int Client::InitKey(uint64_t key, uint64_t nbytes) {
  std::lock_guard<std::mutex> lk(mu_);
  // nbytes rides the version field (payload-free frame)
  return Roundtrip(kInit, key, nbytes, nullptr, 0, nullptr, 0, nullptr,
                   0, 0, nullptr);
}

int Client::Push(uint64_t key, const void* data, uint64_t nbytes,
                 uint8_t codec, uint16_t worker_id, uint64_t version,
                 uint32_t crc) {
  std::lock_guard<std::mutex> lk(mu_);
  return Roundtrip(kPush, key, version, data,
                   static_cast<uint32_t>(nbytes), nullptr, 0, nullptr,
                   codec, worker_id, nullptr, crc);
}

int Client::Pull(uint64_t key, void* data, uint64_t nbytes, uint64_t version,
                 uint8_t codec, uint64_t* out_bytes, bool want_crc,
                 uint32_t* out_crc, int worker_id, uint16_t* out_epoch,
                 uint64_t* out_round) {
  std::lock_guard<std::mutex> lk(mu_);
  const uint16_t wid =
      worker_id >= 0 ? static_cast<uint16_t>(worker_id + 1) : 0;
  // request crc = 1 is the "checksum the response" marker (any nonzero
  // value works; the pull request itself has no payload to checksum);
  // out_round = the response header's version field, i.e. the round the
  // server actually SERVED (>= requested − BYTEPS_STALENESS)
  return Roundtrip(kPull, key, version, nullptr, 0, data, nbytes,
                   out_bytes, codec, wid, out_round, want_crc ? 1u : 0u,
                   out_crc, out_epoch);
}

int Client::Barrier(int worker_id) {
  std::lock_guard<std::mutex> lk(mu_);
  const uint16_t wid =
      worker_id >= 0 ? static_cast<uint16_t>(worker_id + 1) : 0;
  return Roundtrip(kBarrier, 0, 0, nullptr, 0, nullptr, 0, nullptr, 0,
                   wid, nullptr);
}

int Client::Shutdown(int worker_id) {
  std::lock_guard<std::mutex> lk(mu_);
  const uint16_t wid =
      worker_id >= 0 ? static_cast<uint16_t>(worker_id + 1) : 0;
  return Roundtrip(kShutdown, 0, 0, nullptr, 0, nullptr, 0, nullptr, 0,
                   wid, nullptr);
}

int Client::Ping(int64_t* server_ns, int64_t* rtt_ns, int worker_id) {
  std::lock_guard<std::mutex> lk(mu_);
  const int64_t t0 = steady_ns();
  uint64_t sv = 0;
  const uint16_t wid =
      worker_id >= 0 ? static_cast<uint16_t>(worker_id + 1) : 0;
  int rc = Roundtrip(kPing, 0, 0, nullptr, 0, nullptr, 0, nullptr, 0,
                     wid, &sv);
  if (rc == 0) {
    if (server_ns != nullptr) *server_ns = static_cast<int64_t>(sv);
    if (rtt_ns != nullptr) *rtt_ns = steady_ns() - t0;
  }
  return rc;
}

int Client::Members(uint64_t* epoch, uint32_t* live_count,
                    uint32_t* num_workers, uint8_t* bitmap, uint32_t cap) {
  std::lock_guard<std::mutex> lk(mu_);
  // payload: u32 live_count | u32 num_workers | u8 live[num_workers]
  std::vector<char> buf(8 + 65536);
  uint64_t got = 0;
  uint64_t ep = 0;
  int rc = Roundtrip(kMembers, 0, 0, nullptr, 0, buf.data(), buf.size(),
                     &got, 0, 0, &ep);
  if (rc != 0) return rc;
  if (got < 8) {
    Kill();
    return -4;
  }
  uint32_t live = 0;
  uint32_t nw = 0;
  std::memcpy(&live, buf.data(), 4);
  std::memcpy(&nw, buf.data() + 4, 4);
  if (got < 8 + nw) {
    Kill();
    return -4;
  }
  if (epoch != nullptr) *epoch = ep;
  if (live_count != nullptr) *live_count = live;
  if (num_workers != nullptr) *num_workers = nw;
  if (bitmap != nullptr && nw > 0) {
    std::memcpy(bitmap, buf.data() + 8, std::min(nw, cap));
  }
  return 0;
}

int Client::Rounds(void* out, uint64_t cap, uint64_t* got) {
  std::lock_guard<std::mutex> lk(mu_);
  return Roundtrip(kRounds, 0, 0, nullptr, 0, out, cap, got, 0, 0,
                   nullptr);
}

int Client::Join(int worker_id, uint64_t* out_epoch) {
  // range-checked BEFORE the uint16 wire encoding: a truncated id would
  // silently admit a DIFFERENT worker (65536 -> wid 1 -> worker 0).
  // Mirrors the bps_server_join IPC check; -8 = invalid argument.
  if (worker_id < 0 || worker_id > 0xFFFE) return -8;
  std::lock_guard<std::mutex> lk(mu_);
  const uint16_t wid = static_cast<uint16_t>(worker_id + 1);
  uint64_t ep = 0;
  int rc = Roundtrip(kJoin, 0, 0, nullptr, 0, nullptr, 0, nullptr, 0,
                     wid, &ep);
  if (rc == 0 && out_epoch != nullptr) *out_epoch = ep;
  return rc;
}

}  // namespace bps
