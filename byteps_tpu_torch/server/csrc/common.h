// Wire protocol + socket helpers for the DCN parameter-server tier.
//
// Reference analog: 3rdparty/ps-lite message framing (ps::Message over the
// ZMQ/RDMA van) reduced to what the summation service needs: a fixed little-
// endian header + raw payload over TCP. One frame per request/response.
//
// Frame layout (32 bytes header):
//   u32 magic 'BPS1'  | u8 cmd | u8 flags | u16 reserved
//   u64 key           | u64 version       | u32 payload_len | u32 crc
//
// Field use per command:
//   kInit     version = dense store bytes (payload empty)
//   kPush     flags = codec, reserved = worker_id, version = round the
//             push belongs to (0 = unversioned legacy; nonzero versions
//             let the server drop replayed (worker, key, version) pushes
//             from the worker retry engine instead of double-summing),
//             crc = wire_crc of payload (0 = unchecked)
//   kPull     flags = desired response codec, version = min round,
//             reserved = worker_id + 1 (0 = anonymous; nonzero refreshes
//             the worker's membership lease), crc != 0 requests a
//             checksummed response
//   kResp     flags = codec, version = round, payload = encoded result,
//             crc = wire_crc of payload when the pull asked for it
//   kPing     reserved = worker_id + 1 (0 = anonymous clock probe;
//             nonzero is the worker's lease HEARTBEAT and re-admits an
//             evicted worker) -> kAck with version = server
//             CLOCK_REALTIME ns (clock align)
//   kMembers  -> kResp with version = membership epoch, payload =
//             u32 live_count | u32 num_workers | u8 live[num_workers]
//   kRounds   -> kResp, payload = (u64 key, u64 round, u64 nbytes)*
//             for every key store — the rejoin round-watermark handshake
//   kJoin     reserved = worker_id + 1: first-class mid-stream ADMISSION.
//             A fresh id (>= the configured worker count — the membership
//             table GROWS) or a previously evicted/departed one is
//             admitted at a round boundary: epoch bump, open rounds close
//             over their contributors (quorum-scaled), the joiner adopts
//             round watermarks via kRounds before pushing. -> kAck with
//             version = post-admission epoch, or kErr (id out of range /
//             fixed membership)
//
// Every server->worker frame carries the current membership EPOCH in the
// header's reserved field (low 16 bits): workers learn of membership
// changes on their next op and query kMembers for the full live set.
#pragma once

#include <array>
#include <cerrno>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/uio.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

namespace bps {

constexpr uint32_t kMagic = 0x31535042;  // "BPS1"

// Upper bound on any frame payload and on a kInit store allocation: a
// malformed header must not drive a multi-GiB resize (the reference caps
// implicitly via BYTEPS_PARTITION_BYTES; 256 MB is ~64x the default 4 MB
// partition).
constexpr uint32_t kMaxFrameLen = 256u * 1024 * 1024;

enum Cmd : uint8_t {
  kInit = 1,      // allocate store[key] (dense bytes in `version`)
  kPush = 2,      // payload = codec-encoded data to sum into store[key]
  kPull = 3,      // wait until store[key].version >= version, then kResp
  kResp = 4,      // payload = codec-encoded result
  kBarrier = 5,   // block until num_workers barriers arrive
  kShutdown = 6,  // connection is done
  kAck = 7,       // empty acknowledgement
  kErr = 8,       // payload = error string
  kPing = 9,      // clock-offset probe / worker lease heartbeat
  kMembers = 10,  // membership query: epoch + live worker bitmap
  kRounds = 11,   // per-key round watermarks (rejoin adoption)
  kJoin = 12,     // mid-stream worker admission (scale-up elasticity)
};

#pragma pack(push, 1)
struct FrameHeader {
  uint32_t magic = kMagic;
  uint8_t cmd = 0;
  uint8_t flags = 0;
  uint16_t reserved = 0;
  uint64_t key = 0;
  uint64_t version = 0;
  uint32_t len = 0;
  uint32_t crc = 0;  // payload CRC32 (0 = unchecked; was padding)
};
#pragma pack(pop)

static_assert(sizeof(FrameHeader) == 32, "frame header must be 32 bytes");

// CRC-32 (IEEE 802.3 polynomial, zlib-compatible: Python's zlib.crc32
// computes the identical value, which the worker-side verify relies on).
inline uint32_t crc32_of(const void* buf, size_t len) {
  static const std::array<uint32_t, 256> table = [] {
    std::array<uint32_t, 256> t{};
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) {
        c = (c & 1u) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      }
      t[i] = c;
    }
    return t;
  }();
  uint32_t c = 0xFFFFFFFFu;
  const unsigned char* p = static_cast<const unsigned char*>(buf);
  for (size_t i = 0; i < len; ++i) {
    c = table[(c ^ p[i]) & 0xFFu] ^ (c >> 8);
  }
  return c ^ 0xFFFFFFFFu;
}

// CRC as carried on the wire: 0 means "unchecked", so the one-in-2^32
// payload whose true CRC is 0 is mapped to 1 by BOTH sides (sender and
// verifier apply the same adjustment before comparing).
inline uint32_t wire_crc(const void* buf, size_t len) {
  uint32_t c = crc32_of(buf, len);
  return c != 0 ? c : 1u;
}

// Full-buffer send/recv (TCP gives a byte stream; short reads are normal).
inline bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

// Returns false on error/close; a receive timeout (SO_RCVTIMEO expiry)
// leaves errno == EAGAIN/EWOULDBLOCK for the caller to distinguish.
inline bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    if (r == 0) return false;  // peer closed
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// Read and discard n payload bytes so the stream stays framed after an
// unexpected-length response (a desynchronized connection would misparse
// every later header).
inline bool drain_bytes(int fd, size_t n) {
  char sink[4096];
  while (n > 0) {
    size_t chunk = n < sizeof(sink) ? n : sizeof(sink);
    if (!recv_all(fd, sink, chunk)) return false;
    n -= chunk;
  }
  return true;
}

inline bool send_frame(int fd, Cmd cmd, uint64_t key, uint64_t version,
                       const void* payload, uint32_t len, uint8_t flags = 0,
                       uint16_t reserved = 0, uint32_t crc = 0) {
  FrameHeader h;
  h.cmd = cmd;
  h.flags = flags;
  h.reserved = reserved;
  h.key = key;
  h.version = version;
  h.len = len;
  h.crc = crc;
  // scatter-gather write: header + payload leave in one sendmsg (one
  // syscall and one coalesced TCP segment stream instead of two sends
  // per frame; MSG_NOSIGNAL keeps the no-SIGPIPE contract of send_all)
  iovec iov[2];
  iov[0].iov_base = &h;
  iov[0].iov_len = sizeof(h);
  iov[1].iov_base = const_cast<void*>(payload);
  iov[1].iov_len = len;
  msghdr msg{};
  msg.msg_iov = iov;
  msg.msg_iovlen = len > 0 ? 2 : 1;
  while (msg.msg_iovlen > 0) {
    ssize_t w = ::sendmsg(fd, &msg, MSG_NOSIGNAL);
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    size_t n = static_cast<size_t>(w);
    while (msg.msg_iovlen > 0 && n >= msg.msg_iov[0].iov_len) {
      n -= msg.msg_iov[0].iov_len;
      ++msg.msg_iov;
      --msg.msg_iovlen;
    }
    if (msg.msg_iovlen > 0 && n > 0) {
      msg.msg_iov[0].iov_base =
          static_cast<char*>(msg.msg_iov[0].iov_base) + n;
      msg.msg_iov[0].iov_len -= n;
    }
  }
  return true;
}

inline void set_nodelay(int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

// Large socket buffers: a 4 MB partition should stream without the default
// ~200 KB windows throttling loopback throughput.
inline void set_bufsizes(int fd, int bytes = 8 * 1024 * 1024) {
  ::setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &bytes, sizeof(bytes));
  ::setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &bytes, sizeof(bytes));
}

inline void set_recv_timeout(int fd, int timeout_ms) {
  if (timeout_ms <= 0) return;
  timeval tv;
  tv.tv_sec = timeout_ms / 1000;
  tv.tv_usec = (timeout_ms % 1000) * 1000;
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
}

}  // namespace bps
