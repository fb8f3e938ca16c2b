"""byteps_tpu_torch.server — the DCN-tier parameter server (summation
service) and its worker-side client, the port's counterpart of
``byteps_tpu/server``.

Reference analogs: ``byteps/server/server.{h,cc}`` (the service itself,
started by ``import byteps.server`` from the launcher) and the worker-side
``ps::KVWorker`` usage in ``byteps/common/core_loops.cc`` PUSH/PULL stages.

Topology: ``DMLC_NUM_SERVER`` summation servers listen on
``DMLC_PS_ROOT_PORT + 1 + server_id`` at ``DMLC_PS_ROOT_URI``. Partition
keys are assigned to servers by ``key % num_server``. ``python -m
byteps_tpu_torch.server`` serves until every worker said goodbye.

Pushes and pulls carry a wire-codec id (``compression/wire.py`` formats):
the server decompresses each push into an fp32 accumulator and re-compresses
round results for compressed pulls — the reference server's
decompress→sum→recompress engine (SURVEY §2.2/§3.3).

Ported: placement, per-key round tracking with replay-safe re-sends,
the wire retry loop, CRC32 payload checks (``BYTEPS_WIRE_CRC``), byte
accounting and the bandwidth pacer. Not ported yet, and refused by
:func:`~byteps_tpu_torch.common.config.check_ported` when asked for:
server failover, the health monitor, worker leases and elastic
membership, bounded staleness and asynchronous rounds, the in-process
IPC path and fault injection. Importing this package neither builds nor
loads the native library; the first server or connection does.
"""

from __future__ import annotations

import itertools
import random
import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from byteps_tpu_torch.common.config import Config, check_ported, get_config
from byteps_tpu_torch.common.logging import get_logger
from byteps_tpu_torch.common.metrics import get_registry
from byteps_tpu_torch.server.native import (
    WIRE_RAW,
    NativeClient,
    WireCorruption,
    WorkerEvictedError,
    load_lib,
    reduce_sum_f32,
)
from byteps_tpu_torch.server.pacer import DcnPacer, pacer_from_mbps

log = get_logger("server")

__all__ = [
    "start_server", "start_server_any_port", "stop_server", "any_port",
    "serve_forever", "server_addresses", "PSWorker", "reduce_sum_f32",
    "DcnPacer", "WireCorruption", "WorkerEvictedError", "wire_crc32",
]

# Sequential id per PSWorker instance: each emulated NIC gets its own
# per-NIC metric series (wire.nic<N>.*) beside the process aggregates.
_NIC_SEQ = itertools.count()


def wire_crc32(buf) -> int:
    """CRC32 as carried in the frame header: 0 means 'unchecked', so the
    one-in-2^32 payload whose true CRC is 0 maps to 1 (the C++ side's
    wire_crc applies the identical adjustment)."""
    c = zlib.crc32(buf) & 0xFFFFFFFF
    return c if c != 0 else 1


def _is_retryable_wire_error(e: BaseException) -> bool:
    """Errors the worker retry engine may safely re-attempt: lost
    responses (rc=-7), desynchronized/killed sockets (rc=-6/-2/-3, the
    next attempt reconnects) and detected corruption (CRC). Server-side
    kErr rejections (size/init mismatches, pull deadline expiry) are
    semantic failures a resend cannot fix."""
    if isinstance(e, (TimeoutError, ConnectionError, WireCorruption)):
        return True
    if isinstance(e, RuntimeError):
        s = str(e)
        return ("rc=-2" in s or "rc=-3" in s or "key mismatch" in s
                or "NativeClient is closed" in s)
    return False


def server_addresses(cfg: Optional[Config] = None) -> List[Tuple[str, int]]:
    cfg = cfg or get_config()
    num = max(1, cfg.num_server)
    return [(cfg.ps_root_uri, cfg.ps_root_port + 1 + i) for i in range(num)]


def start_server(
    port: Optional[int] = None,
    num_workers: Optional[int] = None,
    engine_threads: Optional[int] = None,
    server_id: int = 0,
    pull_timeout_ms: Optional[int] = None,
    enable_schedule: Optional[bool] = None,
) -> int:
    """Start the native summation service in this process (non-blocking);
    returns the port. Rounds are synchronous: every worker's push of a
    round is summed before any pull of it is answered."""
    cfg = get_config()
    check_ported(cfg)
    lib = load_lib()
    port = port if port is not None else cfg.ps_root_port + 1 + server_id
    rc = lib.bps_server_start(
        port,
        num_workers if num_workers is not None else cfg.num_worker,
        engine_threads if engine_threads is not None
        else cfg.server_engine_threads,
        0,  # asynchronous rounds: not ported
        pull_timeout_ms if pull_timeout_ms is not None
        else cfg.pull_timeout_ms,
        server_id,
        1 if (enable_schedule if enable_schedule is not None
              else cfg.server_enable_schedule) else 0,
        0,  # worker leases: not ported
        0,  # bounded staleness: not ported
    )
    if rc != 0:
        raise RuntimeError(f"bps_server_start failed (rc={rc}, port={port})")
    log.info("summation server listening on :%d", port)
    return port


def stop_server() -> None:
    load_lib().bps_server_stop()


def any_port(bind, port: int, attempts: int = 16, stride: int = 1):
    """Probe ``attempts`` ports ``stride`` apart until ``bind(p)``
    succeeds, sidestepping ephemeral-port squatters: when the OS
    ip_local_port_range overlaps the chosen port, any client socket can be
    sitting on it and the bind fails — rc=-2 from the native server,
    EADDRINUSE from a Python socket. Returns whatever ``bind`` returned for
    the port that stuck; any OTHER bind error propagates."""
    import errno

    last: Optional[Exception] = None
    for i in range(attempts):
        p = port + i * stride
        try:
            return bind(p)
        except RuntimeError as e:
            if "rc=-2" not in str(e):
                raise
            last = e
        except OSError as e:
            if e.errno not in (errno.EADDRINUSE, errno.EACCES):
                raise
            last = e
    raise RuntimeError(
        f"no squatter-free port in {attempts} probes from {port}") from last


def start_server_any_port(port: int, attempts: int = 16, stride: int = 1,
                          **kw) -> int:
    """``start_server`` through the :func:`any_port` squatter sidestep;
    returns the port actually bound."""
    return any_port(lambda p: start_server(port=p, **kw), port,
                    attempts=attempts, stride=stride)


def serve_forever(server_id: Optional[int] = None) -> None:
    """The server role's entry: start, and block until every worker shut
    down (reference: ``import byteps.server`` → ``StartPS`` blocks)."""
    import os

    sid = (server_id if server_id is not None
           else int(os.environ.get("DMLC_SERVER_ID", "0")))
    start_server(server_id=sid)
    load_lib().bps_server_wait()
    log.info("summation server stopped")


class PSWorker:
    """Worker-side facade: key→server placement, per-key round tracking,
    connection-per-thread for pipelined push/pull, wire-byte accounting.

    Each OS thread (one per scheduler pool slot) gets its own serial
    connection to each server, so a pull blocked on a slow round never
    stalls another partition's push — the deadlock-freedom argument of the
    reference's separate PUSH/PULL core loops.

    With ``BYTEPS_DCN_THROTTLE_MBPS`` > 0 (or ``throttle_mbps=``), this
    worker's payload bytes are paced through an emulated full-duplex NIC
    of that speed (``server/pacer.py``).
    """

    def __init__(
        self,
        servers: Optional[Sequence[Tuple[str, int]]] = None,
        timeout_ms: int = 60000,
        recv_timeout_ms: int = 120000,
        worker_id: Optional[int] = None,
        throttle_mbps: Optional[float] = None,
    ):
        cfg = get_config()
        check_ported(cfg)
        self._servers = list(servers) if servers else server_addresses(cfg)
        self._timeout = timeout_ms
        self._recv_timeout = recv_timeout_ms
        self._worker_id = (
            worker_id if worker_id is not None else cfg.worker_id
        )
        self._tls = threading.local()
        self._versions: Dict[int, int] = {}
        self._vlock = threading.Lock()
        self._all_conns: List[NativeClient] = []
        self._conn_lock = threading.Lock()
        self._closed = False
        # wire accounting (compression tests and the smoke assert these)
        self.bytes_pushed = 0
        self.bytes_pulled = 0
        self.pacer: Optional[DcnPacer] = pacer_from_mbps(
            throttle_mbps if throttle_mbps is not None
            else cfg.dcn_throttle_mbps
        )
        self._crc = bool(cfg.wire_crc)
        self._retry_limit = max(0, cfg.retry_limit)
        self._backoff_ms = max(1, cfg.retry_backoff_ms)
        # seeded jitter: reproducible backoff schedules per worker
        self._retry_rng = random.Random(0xC0FFEE ^ (self._worker_id * 7919))
        self.counters: Dict[str, int] = {
            "retries": 0, "timeouts": 0, "conn_errors": 0,
            "crc_errors": 0, "give_ups": 0,
        }
        self._counter_lock = threading.Lock()
        # every robustness count and wire byte also lands in the
        # process-wide metrics registry, resolved once here
        self._nic_tag = f"nic{next(_NIC_SEQ)}"
        _reg = get_registry()
        self._m_counts: Dict[str, Tuple] = {}
        self._m_push_bytes = _reg.counter("wire.push_bytes")
        self._m_pull_bytes = _reg.counter("wire.pull_bytes")
        self._m_push_bytes_nic = _reg.counter(
            f"wire.{self._nic_tag}.push_bytes")
        self._m_pull_bytes_nic = _reg.counter(
            f"wire.{self._nic_tag}.pull_bytes")
        self._m_push_size = _reg.histogram("wire.push_size_bytes")
        self._m_attempts = {
            op: (_reg.counter(f"wire.{op}_attempts"),
                 _reg.counter(f"wire.{self._nic_tag}.{op}_attempts"))
            for op in ("push", "pull", "init")
        }

    def _count(self, name: str, n: int = 1) -> None:
        with self._counter_lock:
            self.counters[name] = self.counters.get(name, 0) + n
        m = self._m_counts.get(name)
        if m is None:
            _reg = get_registry()
            m = (_reg.counter(f"psworker.{name}"),
                 _reg.counter(f"psworker.{self._nic_tag}.{name}"))
            self._m_counts[name] = m
        m[0].inc(n)
        m[1].inc(n)

    def server_for(self, key: int) -> int:
        """The reference's key → server placement: ``key % num_server``."""
        return key % len(self._servers)

    # -- connection management ----------------------------------------------
    def _conn(self, sidx: int) -> NativeClient:
        pool = getattr(self._tls, "conns", None)
        if pool is None:
            pool = {}
            self._tls.conns = pool
        c = pool.get(sidx)
        if c is not None and c.is_dead():
            # a timeout/desync killed the socket (the native side closes it
            # so no stale frame can be misread); evict so this thread's
            # next op reconnects instead of failing rc=-2 forever
            self._evict(sidx, c)
            c = None
        if c is None:
            if self._closed:
                raise RuntimeError("PSWorker is shut down")
            host, port = self._servers[sidx]
            c = NativeClient(host, port, self._timeout, self._recv_timeout)
            pool[sidx] = c
            with self._conn_lock:
                self._all_conns.append(c)
        return c

    def _evict(self, sidx: int, c: NativeClient) -> None:
        pool = getattr(self._tls, "conns", {})
        if pool.get(sidx) is c:
            del pool[sidx]
        with self._conn_lock:
            try:
                self._all_conns.remove(c)
            except ValueError:
                pass
        c.close()

    # -- retry engine -------------------------------------------------------
    def _retry_loop(self, op: str, key: int, attempt_fn):
        """Drive ``attempt_fn(sidx) -> result`` under the per-op retry
        budget (``BYTEPS_RETRY_LIMIT``). Backoff: ``BYTEPS_RETRY_BACKOFF_MS``
        × 2^attempt, capped at 2 s, with seeded jitter in [0.5, 1.0] — the
        standard exponential backoff + jitter that keeps a retry storm from
        re-synchronizing every worker onto the recovering server."""
        sidx = self.server_for(key)
        m_att = self._m_attempts[op]
        attempt = 0
        while True:
            m_att[0].inc()
            m_att[1].inc()
            try:
                return attempt_fn(sidx)
            except BaseException as e:  # noqa: BLE001 - classified below
                if not _is_retryable_wire_error(e):
                    raise
                if attempt >= self._retry_limit:
                    self._count("give_ups")
                    raise
                attempt += 1
                if isinstance(e, TimeoutError):
                    self._count("timeouts")
                elif isinstance(e, WireCorruption):
                    self._count("crc_errors")
                else:
                    self._count("conn_errors")
                self._count("retries")
                log.debug("%s key %d attempt %d failed (%s: %s); retrying",
                          op, key, attempt, type(e).__name__, e)
                backoff = min(self._backoff_ms * (2 ** (attempt - 1)), 2000)
                time.sleep(backoff * self._retry_rng.uniform(0.5, 1.0)
                           / 1e3)

    # -- data plane ---------------------------------------------------------
    def init_key(self, key: int, nbytes: int) -> None:
        """Size key's f32 store on its server (idempotent server-side)."""
        self._retry_loop("init", key,
                         lambda s: self._conn(s).init_key(key, nbytes))

    def mint_version(self, key: int, pinned: Optional[int] = None) -> int:
        """Reserve the round number a push will carry, BEFORE the wire
        attempt — the push stage pins it on its task so a stage retry
        re-sends the SAME round even when the first attempt died before
        ``push_bytes`` could return it. Re-sending the pinned round is
        safe in both failure modes: never-applied → the server sums it as
        round v; applied-but-ack-lost → the (worker, key, version) dedupe
        drops it. A pin beyond the counter is discarded and a fresh round
        minted, exactly like ``push_bytes``'s own rule."""
        with self._vlock:
            cur = self._versions.get(key, 0)
            if pinned is None or pinned > cur:
                pinned = cur + 1
                self._versions[key] = pinned
            return pinned

    def push_bytes(self, key: int, buf: np.ndarray,
                   codec: int = WIRE_RAW,
                   version: Optional[int] = None) -> int:
        """Push codec-encoded bytes; returns the round number the matching
        pull must wait for. Retryable wire failures re-send the SAME
        (worker, key, version) — the server dedupes a replay whose
        original landed, so a lost *response* cannot double-sum the round.
        ``version`` pins the round across higher-level (stage) retries."""
        with self._vlock:
            cur = self._versions.get(key, 0)
            if version is None or version > cur:
                version = cur + 1
                self._versions[key] = version
        b = np.ascontiguousarray(buf)
        crc = wire_crc32(b) if self._crc else 0

        def attempt(sidx):
            if self.pacer is not None:
                # book the payload's transmission time on the emulated NIC
                # BEFORE the wire op (every re-send pays wire time again,
                # as it would on a real NIC)
                self.pacer.throttle_send(int(b.nbytes))
            self._conn(sidx).push(key, b, codec, self._worker_id, version,
                                  crc)

        self._retry_loop("push", key, attempt)
        with self._vlock:
            self.bytes_pushed += int(b.nbytes)
        self._m_push_bytes.inc(int(b.nbytes))
        self._m_push_bytes_nic.inc(int(b.nbytes))
        self._m_push_size.observe(int(b.nbytes))
        return version

    def pull_bytes(self, key: int, capacity: int, version: int,
                   codec: int = WIRE_RAW) -> np.ndarray:
        """Pull the round result as codec-encoded bytes. Pull retries are
        naturally idempotent (the round snapshot is immutable)."""

        def attempt(sidx):
            out = np.empty(capacity, np.uint8)
            got, resp_crc = self._conn(sidx).pull(
                key, out, version, codec, want_crc=self._crc,
                worker_id=self._worker_id)
            if self.pacer is not None:
                # book the response's transmission time per ATTEMPT
                self.pacer.throttle_recv(int(got))
            if resp_crc and wire_crc32(out[:got]) != resp_crc:
                raise WireCorruption(
                    f"pull response for key {key} failed CRC "
                    f"(server {sidx}); retrying")
            return out, int(got)

        out, got = self._retry_loop("pull", key, attempt)
        with self._vlock:
            self.bytes_pulled += got
        self._m_pull_bytes.inc(got)
        self._m_pull_bytes_nic.inc(got)
        return out[:got]

    def push(self, key: int, data: np.ndarray) -> int:
        """Push this worker's fp32 partition (raw wire)."""
        data = np.ascontiguousarray(data, dtype=np.float32)
        return self.push_bytes(key, data.view(np.uint8).ravel(), WIRE_RAW)

    def pull(self, key: int, nelems: int, version: int) -> np.ndarray:
        return self.pull_bytes(key, nelems * 4, version,
                               WIRE_RAW).view(np.float32)

    def push_pull(self, key: int, data: np.ndarray) -> np.ndarray:
        v = self.push(key, data)
        return self.pull(key, data.size, v)

    def barrier(self) -> None:
        """Global worker barrier through server 0 (reference: ps-lite
        Postoffice::Barrier via the scheduler)."""
        self._conn(0).barrier(self._worker_id)

    def shutdown(self) -> None:
        """Tell every server this worker is done (a server exits once all
        workers said so), then drop every connection."""
        if self._closed:
            return
        self._closed = True
        # one shutdown per server (not per connection): servers count
        # shutdowns against DMLC_NUM_WORKER
        pool = getattr(self._tls, "conns", {})
        for sidx in range(len(self._servers)):
            try:
                c = pool.get(sidx)
                if c is not None and c.is_dead():
                    c = None  # a killed socket cannot carry the goodbye
                if c is None:
                    host, port = self._servers[sidx]
                    c = NativeClient(host, port, 2000, self._recv_timeout)
                    with self._conn_lock:
                        self._all_conns.append(c)
                c.shutdown(self._worker_id)
            except Exception as e:  # noqa: BLE001 - the server may be gone
                log.debug("shutdown of server %d failed: %s: %s",
                          sidx, type(e).__name__, e)
        with self._conn_lock:
            conns = list(self._all_conns)
            self._all_conns.clear()
        for c in conns:
            c.close()
        self._tls.conns = {}

    def get_counters(self) -> Dict[str, int]:
        """The wire robustness counters (retries, timeouts, connection and
        CRC errors, give-ups)."""
        with self._counter_lock:
            return dict(self.counters)
