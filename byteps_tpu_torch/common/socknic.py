"""Real-socket NIC: framed, CRC-checked TCP transport between processes
(the port's copy of ``byteps_tpu/common/socknic.py``; its frames are byte
for byte the reference's, so a port client talks to a reference listener
and the reverse).

The gradient tier's loss/corruption/death weather is injected at the
PSWorker wire boundary, and the serve tier's KV-block migration delivers
by direct method call (``target.ingest_block``). This module is the REAL
link those seams plug into when the two ends live in different OS
processes:

* **Frame** — ``[u32 magic 'BNC1'][u32 channel][u32 seq][u32 flags]
  [u32 body_len][u32 crc32]`` + body. The CRC is computed over the body
  and verified on BOTH directions, so on-wire damage is detected, never
  delivered — the same contract as the gradient frame's CRC32
  and the KV frame's (:mod:`byteps_tpu_torch.serve.kv_wire`), now
  catching REAL corruption on a real socket instead of an injected byte
  flip.
* **Listener** (:class:`SocketNicListener`) — one accept thread, one
  reader thread per connection, per-channel handlers registered by the
  consumer (the KV endpoint registers :data:`CH_KV_BLOCK`). The listen
  path binds through :func:`byteps_tpu_torch.server.any_port`, the SAME
  ephemeral-port-squatter sidestep the native summation server uses
  (this image's ip_local_port_range starts at 16000, so any client
  socket can squat a fixed port).
* **Client** (:class:`SocketNicClient`) — one lazily-connected socket
  per calling thread (the PSWorker connection-pool discipline), a
  blocking ``request`` per frame. Real connection errors surface in
  the EXISTING retryable/wire-death taxonomy: ``ECONNRESET``/refused
  arrive as ``ConnectionError`` subclasses and a recv deadline raises
  ``TimeoutError`` — exactly the types
  ``server._is_retryable_wire_error`` classifies retryable — while a
  CRC reject comes back as :class:`SockWireCorruption`
  (``retryable=True``: the re-send is pristine) and a handler-side
  failure as :class:`SockRemoteError` (``retryable=False`` unless the
  relayed type says otherwise). Payload bytes are shaped through an
  optional :class:`~byteps_tpu_torch.server.pacer.DcnPacer` (by default
  one at ``BYTEPS_SOCKET_MBPS``, none at 0): the DCN tier's token
  bucket, here a shaper on a real link.

An optional :class:`~byteps_tpu_torch.common.faults.FaultPlan` intercepts
each client request (op ``"push"``): ``corrupt`` flips a byte of the
ENCODED frame after the CRC was stamped — so the damage crosses the
real wire and the LISTENER's CRC catches it — ``kill``/``down`` drop
the socket before sending, ``timeout`` sends then reports the reply
lost. Same grammar, same seeded determinism, real bytes.
"""

from __future__ import annotations

import itertools
import socket
import struct
import threading
import zlib
from typing import Callable, Dict, Optional

from byteps_tpu_torch.common.faults import (
    FaultPlan,
    InjectedConnectionError,
    InjectedTimeout,
)
from byteps_tpu_torch.common.logging import get_logger
from byteps_tpu_torch.common.metrics import get_registry

log = get_logger("socknic")

__all__ = [
    "CH_PING", "CH_KV_BLOCK", "SockWireCorruption", "SockRemoteError",
    "SocketNicListener", "SocketNicClient",
]

_MAGIC = 0x42_4E_43_31  # "BNC1"
_HDR = struct.Struct("<IIIIII")  # magic, channel, seq, flags, len, crc
_FLAG_REPLY = 0x1
_FLAG_ERROR = 0x2

# channel ids are a tiny fixed registry, not a negotiation: both ends
# of a wire are this codebase
CH_PING = 0
CH_KV_BLOCK = 1

# per-instance registry series (as the pacer's pacer.p<N>): listeners
# and clients each get their own socknic.l<N>./socknic.c<N>. counters
_LISTENER_SEQ = itertools.count()
_CLIENT_SEQ = itertools.count()


class SockWireCorruption(RuntimeError):
    """Frame CRC mismatch — the bytes were damaged on the wire (or by an
    armed ``corrupt`` fault rule). Retryable: the re-send re-encodes
    from the pristine payload."""

    retryable = True


class SockRemoteError(RuntimeError):
    """A handler on the listener side raised; the error crossed back as
    a typed reply. Not retryable by default — re-sending the same bytes
    re-raises the same handler error — unless the relayed type is
    mapped to something that says otherwise (``error_types``)."""

    retryable = False


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionResetError(
                "socket closed mid-frame (peer died or reset)")
        buf.extend(chunk)
    return bytes(buf)


def _frame(channel: int, seq: int, flags: int, body: bytes) -> bytes:
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return _HDR.pack(_MAGIC, channel, seq, flags, len(body), crc) + body


def _read_frame(conn: socket.socket):
    """-> (channel, seq, flags, body, crc_ok). A bad CRC is reported,
    not raised: the READER survives a damaged frame (the peer retries),
    only a malformed header kills the connection."""
    hdr = _recv_exact(conn, _HDR.size)
    magic, channel, seq, flags, blen, crc = _HDR.unpack(hdr)
    if magic != _MAGIC:
        raise ConnectionResetError(
            f"bad socknic frame magic {magic:#x} — desynced stream")
    body = _recv_exact(conn, blen) if blen else b""
    return channel, seq, flags, body, (zlib.crc32(body) & 0xFFFFFFFF) == crc


class SocketNicListener:
    """One process's inbound NIC: accept loop + per-channel handlers.

    ``handlers[channel] = fn(body: bytes) -> bytes`` runs on the
    connection's reader thread; its return value is the reply body. A
    handler exception is relayed to the client as a typed error reply
    (``"ExcTypeName: message"``) — the client re-raises it through its
    ``error_types`` map. A frame whose CRC fails is rejected with
    :class:`SockWireCorruption` (counted in ``socknic.l<N>.crc_rejects``)
    and the connection stays up: corruption costs a retry, never a link.
    """

    def __init__(self, port: int, attempts: int = 16, stride: int = 1,
                 host: str = "127.0.0.1"):
        # the native server's ephemeral-port-squatter sidestep, reused;
        # imported lazily to keep common -> server one-way at import time
        from byteps_tpu_torch.server import any_port

        self._handlers: Dict[int, Callable[[bytes], Optional[bytes]]] = {
            CH_PING: lambda body: body,  # echo — liveness probe
        }
        self._conns: list = []
        self._lock = threading.Lock()
        self._closed = False
        tag = f"socknic.l{next(_LISTENER_SEQ)}"
        _reg = get_registry()
        self._m_accepts = _reg.counter(f"{tag}.accepts")
        self._m_frames = _reg.counter(f"{tag}.frames")
        self._m_crc_rejects = _reg.counter(f"{tag}.crc_rejects")
        self._m_handler_errors = _reg.counter(f"{tag}.handler_errors")
        self._m_bytes_in = _reg.counter(f"{tag}.bytes_in")
        self._m_bytes_out = _reg.counter(f"{tag}.bytes_out")

        def _bind(p: int) -> socket.socket:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                s.bind((host, p))
            except OSError:
                s.close()
                raise
            return s

        self._sock = any_port(_bind, port, attempts=attempts,
                              stride=stride)
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"{tag}.accept", daemon=True)
        self._accept_thread.start()

    def register(self, channel: int,
                 fn: Callable[[bytes], Optional[bytes]]) -> None:
        self._handlers[int(channel)] = fn

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # listener closed
            self._m_accepts.inc()
            with self._lock:
                self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._closed:
                channel, seq, _flags, body, crc_ok = _read_frame(conn)
                self._m_frames.inc()
                self._m_bytes_in.inc(_HDR.size + len(body))
                if not crc_ok:
                    # damaged on the wire: reject loudly, keep the link —
                    # the client's retry re-sends pristine bytes
                    self._m_crc_rejects.inc()
                    reply = _frame(
                        channel, seq, _FLAG_REPLY | _FLAG_ERROR,
                        b"SockWireCorruption: frame CRC mismatch at "
                        b"the listener")
                else:
                    fn = self._handlers.get(channel)
                    try:
                        if fn is None:
                            raise SockRemoteError(
                                f"no handler for channel {channel}")
                        out = fn(body) or b""
                        reply = _frame(channel, seq, _FLAG_REPLY, out)
                    except Exception as e:  # noqa: BLE001 - relayed to
                        # the client as a TYPED reply; the wire itself
                        # must survive any handler failure
                        self._m_handler_errors.inc()
                        msg = f"{type(e).__name__}: {e}".encode(
                            "utf-8", "replace")
                        reply = _frame(channel, seq,
                                       _FLAG_REPLY | _FLAG_ERROR, msg)
                conn.sendall(reply)
                self._m_bytes_out.inc(len(reply))
        except (ConnectionError, OSError):
            pass  # peer went away — its client surface reports it
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


class SocketNicClient:
    """One process's outbound NIC to a listener: blocking request/reply.

    Thread-safe the PSWorker way — one lazily-dialed socket per calling
    thread — so concurrent stage-pool threads never interleave frames.
    Errors keep their taxonomy: connect/sendall/recv surface
    ``ConnectionError`` (dead peer — retryable, and the next attempt
    redials), the recv deadline raises ``TimeoutError`` (retryable; the
    socket is dropped so no stale reply can be misread), a CRC reject
    raises :class:`SockWireCorruption`, and a relayed handler error is
    re-raised through ``error_types`` (falling back to
    :class:`SockRemoteError`, not retryable).
    """

    def __init__(self, host: str, port: int,
                 timeout_ms: Optional[int] = None,
                 pacer=None,
                 fault_plan: Optional[FaultPlan] = None,
                 error_types: Optional[Dict[str, type]] = None):
        from byteps_tpu_torch.common.config import get_config
        from byteps_tpu_torch.server.pacer import pacer_from_mbps

        cfg = get_config()
        self.host = host
        self.port = int(port)
        self._timeout_s = (timeout_ms if timeout_ms is not None
                           else cfg.socket_timeout_ms) / 1e3
        self._pacer = (pacer if pacer is not None
                       else pacer_from_mbps(cfg.socket_mbps))
        self._plan = fault_plan
        self._types = {"SockWireCorruption": SockWireCorruption}
        self._types.update(error_types or {})
        self._tls = threading.local()
        self._seq = itertools.count(1)
        self._closed = False
        self._all_socks: list = []
        self._socks_lock = threading.Lock()
        tag = f"socknic.c{next(_CLIENT_SEQ)}"
        _reg = get_registry()
        self._m_requests = _reg.counter(f"{tag}.requests")
        self._m_bytes_sent = _reg.counter(f"{tag}.bytes_sent")
        self._m_bytes_recv = _reg.counter(f"{tag}.bytes_recv")
        self._m_conn_errors = _reg.counter(f"{tag}.conn_errors")
        self._m_timeouts = _reg.counter(f"{tag}.timeouts")
        self._m_crc_errors = _reg.counter(f"{tag}.crc_errors")
        self._m_remote_errors = _reg.counter(f"{tag}.remote_errors")

    # -- connection management (per-thread, PSWorker-style) ------------------
    def _sock_get(self) -> socket.socket:
        s = getattr(self._tls, "sock", None)
        if s is None:
            if self._closed:
                raise RuntimeError("SocketNicClient is closed")
            s = socket.create_connection((self.host, self.port),
                                         timeout=self._timeout_s)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._tls.sock = s
            with self._socks_lock:
                self._all_socks.append(s)
        return s

    def _sock_drop(self) -> None:
        s = getattr(self._tls, "sock", None)
        if s is not None:
            self._tls.sock = None
            try:
                s.close()
            except OSError:
                pass

    def request(self, channel: int, body: bytes) -> bytes:
        """One framed request; returns the reply body. Exceptions leave
        the socket DROPPED so the caller's retry redials clean."""
        self._m_requests.inc()
        seq = next(self._seq)
        buf = bytearray(_frame(channel, seq, 0, body))
        inj = self._plan.intercept("push", -1) if self._plan else None
        if inj is not None and inj.kind in ("kill", "down"):
            self._sock_drop()
            raise InjectedConnectionError(
                f"injected {inj.kind} on socknic request ch={channel}")
        if inj is not None and inj.kind == "corrupt":
            # flip a BODY byte after the CRC was stamped: the damage
            # rides the real wire and the LISTENER's CRC catches it
            i = _HDR.size + (inj.corrupt_at % max(1, len(body)))
            buf[i] ^= 0xFF
        if self._pacer is not None:
            self._pacer.throttle_send(len(buf))
        try:
            s = self._sock_get()
            s.sendall(bytes(buf))
            self._m_bytes_sent.inc(len(buf))
            rch, rseq, rflags, rbody, crc_ok = _read_frame(s)
        except socket.timeout:
            self._m_timeouts.inc()
            self._sock_drop()
            raise TimeoutError(
                f"socknic recv deadline ({self._timeout_s:.1f}s) to "
                f"{self.host}:{self.port}") from None
        except ConnectionError:
            self._m_conn_errors.inc()
            self._sock_drop()
            raise
        except OSError as e:
            # e.g. EPIPE on a half-dead socket: same class of death
            self._m_conn_errors.inc()
            self._sock_drop()
            raise ConnectionError(
                f"socknic request to {self.host}:{self.port} failed: "
                f"{e}") from e
        self._m_bytes_recv.inc(_HDR.size + len(rbody))
        if self._pacer is not None:
            self._pacer.throttle_recv(_HDR.size + len(rbody))
        if rseq != seq or rch != channel:
            self._sock_drop()
            raise ConnectionError(
                f"socknic reply desync (sent ch={channel} seq={seq}, "
                f"got ch={rch} seq={rseq})")
        if not crc_ok:
            self._m_crc_errors.inc()
            raise SockWireCorruption(
                "socknic reply CRC mismatch — frame damaged in flight")
        if rflags & _FLAG_ERROR:
            name, _, msg = rbody.decode("utf-8", "replace").partition(": ")
            exc = self._types.get(name)
            if name == "SockWireCorruption":
                self._m_crc_errors.inc()
            else:
                self._m_remote_errors.inc()
            if exc is not None:
                raise exc(msg)
            raise SockRemoteError(f"{name}: {msg}")
        if inj is not None and inj.kind == "timeout":
            # delivered, reply lost: the retry's re-send is the peer
            # handler's idempotency problem, same as every wire seam
            self._sock_drop()
            raise InjectedTimeout(
                f"injected timeout on socknic request ch={channel}")
        return rbody

    def ping(self, payload: bytes = b"socknic") -> bytes:
        return self.request(CH_PING, payload)

    def close(self) -> None:
        self._closed = True
        with self._socks_lock:
            socks, self._all_socks = self._all_socks, []
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
