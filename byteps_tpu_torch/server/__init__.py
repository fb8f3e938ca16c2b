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
accounting, the bandwidth pacer, and the client's half of robustness
(docs/robustness.md): fault injection from a seeded plan
(``BYTEPS_FAULT_SPEC``, ``common/faults.py``), the health monitor
(``BYTEPS_HEALTH_INTERVAL_MS``), and server failover with key remap (a
dead server's keys move to the survivors by rendezvous hash, with fresh
round numbers and a lazy re-init), the owner handoff of a pod of
several controllers (:func:`hand_off_owner`, :func:`retire_nic`), and
the in-process IPC path (``BYTEPS_ENABLE_IPC``: a worker in the process
of a running server reaches its store without TCP), and elastic
membership: worker leases (``BYTEPS_WORKER_LEASE_MS``: a silent worker
is evicted, the membership epoch bumps, open rounds close over the
survivors, quorum-scaled), the epoch adoption that gives each round its
own live count, the rejoin of an evicted worker, the mid-stream join
(kJoin), bounded staleness (``BYTEPS_STALENESS``) and asynchronous
rounds (``BYTEPS_ENABLE_ASYNC``). Importing this package neither builds
nor loads the native library; the first server or connection does.
"""

from __future__ import annotations

import ctypes
import itertools
import random
import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from byteps_tpu_torch.common.config import Config, check_ported, get_config
from byteps_tpu_torch.common.faults import (
    FaultPlan,
    InjectedConnectionError,
    InjectedTimeout,
    ServerDownError,
    WorkerKilledError,
    plan_from_env,
)
from byteps_tpu_torch.common.logging import get_logger
from byteps_tpu_torch.common.metrics import get_registry
from byteps_tpu_torch.server.native import (
    WIRE_RAW,
    NativeClient,
    WireCorruption,
    WorkerEvictedError,
    check_local,
    load_lib,
    reduce_sum_f32,
)
from byteps_tpu_torch.server.pacer import DcnPacer, pacer_from_mbps

log = get_logger("server")

__all__ = [
    "start_server", "start_server_any_port", "stop_server", "any_port",
    "serve_forever", "server_addresses", "PSWorker", "reduce_sum_f32",
    "DcnPacer", "FailedOverError", "NoLiveServersError", "WireCorruption",
    "WorkerEvictedError", "WorkerKilledError", "wire_crc32",
    "hand_off_owner", "retire_nic",
]

# Sequential id per PSWorker instance: each emulated NIC gets its own
# per-NIC metric series (wire.nic<N>.*) beside the process aggregates.
_NIC_SEQ = itertools.count()

# (server, epoch) -> live count entries kept in PSWorker._epoch_live: every
# membership change adds one, so entries further than this many epochs
# from the newest are pruned (a round that stale falls back to the
# adopted live count)
_EPOCH_LIVE_WINDOW = 64

# A data-plane connect retries for the worker's whole connect budget (the
# server may still be starting), in slices this long, so that a connect
# to a server failed over meanwhile gives up.
_CONNECT_SLICE_MS = 500


def wire_crc32(buf) -> int:
    """CRC32 as carried in the frame header: 0 means 'unchecked', so the
    one-in-2^32 payload whose true CRC is 0 maps to 1 (the C++ side's
    wire_crc applies the identical adjustment)."""
    c = zlib.crc32(buf) & 0xFFFFFFFF
    return c if c != 0 else 1


class FailedOverError(RuntimeError):
    """The key's server placement changed (failover) while this op was in
    flight; its round numbering is gone. Not retryable at the wire level:
    the *stage* retry re-runs the op, which re-derives version and target
    against the post-failover topology."""


class NoLiveServersError(ConnectionError):
    """Every summation server is marked dead. Excluded from the wire retry
    budget (re-sending cannot help), but stage-retryable: the re-run of
    the PUSH stage takes the degraded branch when BYTEPS_DEGRADED_OK, else
    fails the handle."""


def hand_off_owner(workers, owners, rank: int):
    """The owner-failover handoff, shared by ``DcnCore`` and the hybrid
    pipeline of ``eager`` (the caller holds its own lock around it):
    fence the dying controller's worker, so that it mints no round past
    the snapshot; export its round counters and store sizes; adopt them
    into every survivor; then fail ``rank`` in ``owners``, in that order.
    Fence before export closes the mint race; export before the fail
    keeps a racing stage retry from minting a round at or below the
    server's replay watermark. Returns the live set from before the fail
    (callers diff it to find the partitions that moved), or None if
    ``rank`` is already dead or the last controller."""
    live = owners.live()
    if rank not in live or len(live) <= 1:
        return None
    workers[rank].fence()
    versions, nbytes = workers[rank].export_rounds()
    for r in sorted(live - {rank}):
        workers[r].adopt_rounds(versions, nbytes)
    owners.fail(rank)
    return live


def retire_nic(worker: "PSWorker") -> None:
    """Free an extra pod controller's NIC (owner failover or the pod's
    shutdown): count ``nic.retired`` and close the worker (its health
    monitor, connections and pacer). Its counters stay in the registry
    under ``wire.nic<N>.*`` and ``psworker.nic<N>.*``. A NIC retires
    once: a pod's shutdown passes over one an owner failover retired.
    NIC 0 never retires: it alone carries the pod's one goodbye round
    (servers count one a pod), through :meth:`PSWorker.shutdown`."""
    if worker._closed:
        return
    get_registry().counter("nic.retired").inc()
    worker.close()


def _is_retryable_wire_error(e: BaseException) -> bool:
    """Errors the worker retry engine may safely re-attempt: lost
    responses (rc=-7), desynchronized/killed sockets (rc=-6/-2/-3, the
    next attempt reconnects), detected corruption (CRC), and injected
    equivalents. Server-side kErr rejections (size/init mismatches, pull
    deadline expiry) are semantic failures a resend cannot fix."""
    if isinstance(e, (NoLiveServersError, FailedOverError)):
        return False
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


# server_id of the summation service running in this process, if any: a
# PSWorker with IPC on routes that server's keys through the in-process
# path instead of TCP loopback
_INPROC_SERVER_ID: Optional[int] = None


def start_server(
    port: Optional[int] = None,
    num_workers: Optional[int] = None,
    engine_threads: Optional[int] = None,
    async_mode: Optional[bool] = None,
    server_id: int = 0,
    pull_timeout_ms: Optional[int] = None,
    enable_schedule: Optional[bool] = None,
    lease_ms: Optional[int] = None,
    staleness: Optional[int] = None,
) -> int:
    """Start the native summation service in this process (non-blocking);
    returns the port. Rounds are synchronous by default: every live
    worker's push of a round is summed before any pull of it is answered.

    ``lease_ms`` (default ``BYTEPS_WORKER_LEASE_MS``) > 0 arms worker
    leases: a worker silent past the lease is evicted, the membership
    epoch bumps, open rounds close over the live workers (scaled by
    live/contributors) and stuck barriers release. ``staleness`` (default
    ``BYTEPS_STALENESS``) K > 0 serves a pull of round v from the newest
    closed round >= v-K and force-closes a round a straggler holds past
    the bound; K = 0 is the synchronous tier bit for bit. ``async_mode``
    (default ``BYTEPS_ENABLE_ASYNC``, the K = inf limit, wins over K):
    the store is summed into without rounds or barriers."""
    global _INPROC_SERVER_ID
    cfg = get_config()
    check_ported(cfg)
    lib = load_lib()
    port = port if port is not None else cfg.ps_root_port + 1 + server_id
    rc = lib.bps_server_start(
        port,
        num_workers if num_workers is not None else cfg.num_worker,
        engine_threads if engine_threads is not None
        else cfg.server_engine_threads,
        1 if (async_mode if async_mode is not None else cfg.enable_async)
        else 0,
        pull_timeout_ms if pull_timeout_ms is not None
        else cfg.pull_timeout_ms,
        server_id,
        1 if (enable_schedule if enable_schedule is not None
              else cfg.server_enable_schedule) else 0,
        lease_ms if lease_ms is not None else cfg.worker_lease_ms,
        staleness if staleness is not None else cfg.staleness,
    )
    if rc != 0:
        raise RuntimeError(f"bps_server_start failed (rc={rc}, port={port})")
    _INPROC_SERVER_ID = server_id
    log.info("summation server listening on :%d", port)
    return port


def stop_server() -> None:
    global _INPROC_SERVER_ID
    load_lib().bps_server_stop()
    _INPROC_SERVER_ID = None


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

    Robustness (docs/robustness.md): a fault plan
    (``BYTEPS_FAULT_SPEC``/``BYTEPS_FAULT_SEED``) intercepts every wire
    attempt; a health monitor (``health_interval_ms=``, else
    ``BYTEPS_HEALTH_INTERVAL_MS``) pings every live server and fails one
    over after ``BYTEPS_HEALTH_MISS_LIMIT`` consecutive misses.

    With ``BYTEPS_ENABLE_IPC`` (or ``use_ipc=True``) and a summation
    server running in this process, init, push and pull of the keys that
    server holds skip TCP and reach its store directly (the reference's
    colocated fast path), without a CRC; pushes and pulls run under the
    retry loop and failover as on the wire, an init goes straight to the
    store.

    Elastic membership: every response stamps the server's membership
    epoch; a newer one is adopted from a ``kMembers`` query
    (:meth:`live_pods`, ``membership_events``), and each pull records the
    live count of the epoch its round closed under
    (:meth:`last_round_live`) and the round it was served from
    (:meth:`last_pull_round`). A push refused as evicted rejoins in line
    (:meth:`rejoin`); :meth:`join` admits this worker into a running job.
    """

    def __init__(
        self,
        servers: Optional[Sequence[Tuple[str, int]]] = None,
        timeout_ms: int = 60000,
        recv_timeout_ms: int = 120000,
        worker_id: Optional[int] = None,
        use_ipc: Optional[bool] = None,
        throttle_mbps: Optional[float] = None,
        fault_plan: Optional[FaultPlan] = None,
        health_interval_ms: Optional[int] = None,
    ):
        """``health_interval_ms`` overrides BYTEPS_HEALTH_INTERVAL_MS for
        this worker (a test arms a monitored worker beside one without a
        monitor in one process; None = the config value). ``fault_plan``
        overrides the plan of BYTEPS_FAULT_SPEC for this worker (a pod
        kills one controller's NIC while its siblings stay healthy).
        ``use_ipc`` overrides BYTEPS_ENABLE_IPC; it takes effect only if
        a server runs in this process."""
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
        # set by fence(): an owner failed over mints no more rounds
        self._fenced = False
        self._all_conns: List[NativeClient] = []
        self._conn_lock = threading.Lock()
        self._closed = False
        # wire accounting (compression tests and the smoke assert these)
        self.bytes_pushed = 0
        self.bytes_pulled = 0
        self._ipc = (use_ipc if use_ipc is not None
                     else cfg.enable_ipc) and _INPROC_SERVER_ID is not None
        self.pacer: Optional[DcnPacer] = pacer_from_mbps(
            throttle_mbps if throttle_mbps is not None
            else cfg.dcn_throttle_mbps
        )
        self._plan = (fault_plan if fault_plan is not None
                      else plan_from_env(cfg, worker_id=self._worker_id))
        # CRC is forced on while corruption injection is armed: corruption
        # must be detected to be retried instead of summed. The loss kinds
        # are caught by the rc/desync classification and the version
        # dedupe, and latency touches no payload, so they leave it off.
        self._crc = bool(cfg.wire_crc) or (
            self._plan is not None
            and any(r.kind == "corrupt" for r in self._plan.rules))
        self._retry_limit = max(0, cfg.retry_limit)
        self._backoff_ms = max(1, cfg.retry_backoff_ms)
        # bounded staleness: a pull served a round newer than this worker
        # minted re-syncs its mint counter (pull_bytes)
        self._staleness = max(0, cfg.staleness)
        # seeded jitter: reproducible backoff schedules per worker
        self._retry_rng = random.Random(
            0xC0FFEE ^ (self._worker_id * 7919) ^ cfg.fault_seed)
        self._live: Set[int] = set(range(len(self._servers)))
        self._epoch = 0  # bumped per failover; in-flight ops self-abort
        self._key_nbytes: Dict[int, int] = {}  # for post-failover re-init
        # elastic membership: the epoch (low 16 bits) adopted per server,
        # and (server, epoch) -> live count, the divisor of a round that
        # closed under that epoch (epoch 0: the configured membership)
        self._epoch_seen: Dict[int, int] = {}
        self._epoch_live: Dict[Tuple[int, int], int] = {
            (s, 0): max(1, cfg.num_worker) for s in range(len(self._servers))}
        self._live_pods = max(1, cfg.num_worker)
        # injected self-death (worker:kill) / wedge window (worker:hang)
        self._self_killed = False
        self._wedged_until = 0.0
        # a worker<N>:join rule runs the admission once, however wide its
        # window
        self._join_fired = False
        self.counters: Dict[str, int] = {
            "retries": 0, "timeouts": 0, "conn_errors": 0,
            "crc_errors": 0, "reinits": 0, "give_ups": 0,
            "failovers": 0, "ici_fallbacks": 0,
            "membership_events": 0, "rejoins": 0, "joins": 0,
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
        # bounded staleness: requested - served a pull, and how many rounds
        # this worker's newest mint runs ahead of the round it last
        # consumed (the process's last pull, and this NIC's)
        self._m_staleness = _reg.histogram("server.staleness")
        self._m_rounds_ahead = _reg.gauge("psworker.rounds_ahead")
        self._m_rounds_ahead_nic = _reg.gauge(
            f"psworker.{self._nic_tag}.rounds_ahead")
        self._m_attempts = {
            op: (_reg.counter(f"wire.{op}_attempts"),
                 _reg.counter(f"wire.{self._nic_tag}.{op}_attempts"))
            for op in ("push", "pull", "init")
        }
        self._health: Optional[_HealthMonitor] = None
        hb_ms = (health_interval_ms if health_interval_ms is not None
                 else cfg.health_interval_ms)
        if hb_ms > 0 and self._servers:
            self._health = _HealthMonitor(
                self, interval_ms=hb_ms,
                miss_limit=max(1, cfg.health_miss_limit))
            self._health.start()

    # -- robustness helpers -------------------------------------------------
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

    def _kill_conn(self, sidx: int) -> None:
        """Drop this thread's connection to ``sidx`` (injected socket
        death); the next attempt reconnects through ``_conn``."""
        c = getattr(self._tls, "conns", {}).get(sidx)
        if c is not None:
            self._evict(sidx, c)

    def _inject_pre(self, op: str, sidx: int):
        """Evaluate the fault plan for one wire attempt. 'kill'/'down'
        raise here (the request never leaves); 'timeout'/'corrupt' are
        returned for the caller to act on around the real op. Worker-scope
        rules simulate this process's death ('worker:kill': sticky, every
        later op refuses) or wedge ('worker:hang': ops block out the
        window, then report a lost response); both silence the health
        monitor, whose ping is the lease heartbeat, so the server evicts
        the worker as it would a crashed one. 'worker<N>:join' runs the
        admission (:meth:`join`) once, then lets the op proceed."""
        if self._self_killed:
            raise WorkerKilledError(
                f"worker {self._worker_id} is dead (injected worker:kill); "
                f"{op} refused")
        rest = self._wedged_until - time.time()
        if rest > 0:
            time.sleep(rest)
            self._kill_conn(sidx)
            raise InjectedTimeout(
                f"injected: worker {self._worker_id} wedged through {op} "
                "(worker:hang window)")
        if self._plan is None:
            return None
        inj = self._plan.intercept(op, sidx)
        if inj is None:
            return None
        if inj.rule.scope == "worker":
            if inj.kind == "kill":
                self._self_killed = True
                log.warning(
                    "worker %d killed by injection at plan step %d",
                    self._worker_id, self._plan.step)
                # a dead process's sockets die with it
                for s in list(getattr(self._tls, "conns", {})):
                    self._kill_conn(s)
                raise WorkerKilledError(
                    f"injected: worker {self._worker_id} killed during "
                    f"{op} (plan step {self._plan.step})")
            if inj.kind == "hang":
                self._wedged_until = (time.time()
                                      + inj.rule.latency_ms / 1e3)
                time.sleep(inj.rule.latency_ms / 1e3)
                self._kill_conn(sidx)
                raise InjectedTimeout(
                    f"injected: worker {self._worker_id} wedged for "
                    f"{inj.rule.latency_ms} ms during {op}")
            if inj.kind == "join":
                if not self._join_fired:
                    self._join_fired = True
                    self.join()
                return None
            # other kinds under the worker scope fall through to the
            # generic handling below (worker:timeout = lose own responses)
        if inj.kind == "down":
            self._kill_conn(sidx)
            raise ServerDownError(
                f"injected: server {sidx} down during {op} "
                f"(plan step {self._plan.step})")
        if inj.kind == "kill":
            self._kill_conn(sidx)
            raise InjectedConnectionError(
                f"injected: connection to server {sidx} killed before {op}")
        return inj

    def is_wedged(self) -> bool:
        """True while a worker:hang window is open or after a worker:kill
        (the health monitor goes silent, as a wedged process would)."""
        return self._self_killed or self._wedged_until > time.time()

    def has_live_servers(self) -> bool:
        return bool(self._live)

    def live_servers(self) -> Set[int]:
        return set(self._live)

    def fail_over(self, sidx: int, barrier: bool = True) -> bool:
        """Mark server ``sidx`` dead and remap its keys to the survivors.

        Every worker must take the same view of the live set before any
        pushes the new placement: their health monitors each call this,
        and the worker barrier through the lowest surviving server aligns
        them. Key remap is rendezvous-hashed over the live set; the dead
        server's keys get fresh round counters (their stores, and the
        rounds in flight against them, are gone): in-flight ops for
        remapped keys abort with :class:`FailedOverError` and the stage
        retry re-runs them against the new placement. Returns False if
        the server was already dead."""
        with self._vlock:
            if sidx not in self._live:
                return False
            old_live = set(self._live)
            self._live.discard(sidx)
            self._epoch += 1
            # reset the round numbering of every key whose placement
            # changed, atomically with the live-set shrink: a push racing
            # this either sees the old placement (and aborts) or a reset
            # counter, never a continuation version on the new server,
            # which the server's dedupe watermark would take for replays
            for key in list(self._versions):
                if (self._server_for_live(key, old_live)
                        != self._server_for_live(key, self._live)):
                    del self._versions[key]
        self._count("failovers")
        log.warning("server %d marked dead; %s", sidx,
                    f"keys fail over to {sorted(self._live)}"
                    if self._live else "NO live servers remain "
                    "(degraded mode)")
        if barrier and self._live:
            try:
                self.barrier()
            except Exception as e:  # noqa: BLE001 - best-effort alignment
                log.warning("failover barrier failed: %s", e)
        return True

    def _server_for_live(self, key: int, live: Set[int]) -> int:
        """Deterministic placement agreed across workers: the home slot
        (key % n) when alive, else a rendezvous hash over the survivors
        (zlib.crc32 is stable across processes, unlike salted hash())."""
        home = key % len(self._servers)
        if home in live or not live:
            return home  # no survivors: the degraded path decides upstream
        return max(live,
                   key=lambda s: zlib.crc32(f"{key}:{s}".encode()))

    def server_for(self, key: int) -> int:
        """The key's server over the live set (``key % num_server`` while
        every server lives)."""
        with self._vlock:
            live = set(self._live)
        return self._server_for_live(key, live)

    # -- elastic membership -------------------------------------------------
    def live_pods(self) -> int:
        """Live workers (pods) in the most recently adopted membership
        epoch: what averaging divides by in place of ``DMLC_NUM_WORKER``
        once a peer is evicted or joins."""
        with self._vlock:
            return max(1, self._live_pods)

    def _note_epoch(self, sidx: int) -> None:
        """After every op: compare the epoch the server stamped on its
        response with the adopted one, and adopt a newer one (a mod-2^16
        window; never backwards: a connection idle across a bump still
        holds the old stamp)."""
        try:
            if self._is_local(sidx):
                e = int(load_lib().bps_server_epoch()) & 0xFFFF
            else:
                conn = getattr(self._tls, "conns", {}).get(sidx)
                if conn is None:
                    return
                e = conn.epoch()
        except Exception:  # noqa: BLE001 - the next op detects it again
            return
        with self._vlock:
            seen = self._epoch_seen.get(sidx, 0)
        if e != seen and ((e - seen) & 0xFFFF) < 0x8000:
            self._adopt_membership(sidx)

    def _adopt_membership(self, sidx: int) -> None:
        """Adopt server ``sidx``'s membership from a ``kMembers`` query:
        record the query's own (epoch, live) pair in the divisor history,
        never the stamp that triggered it (another change may have landed
        in between), and adopt the epoch once, whichever pool thread gets
        there first. A failed query leaves the old epoch adopted; the next
        op retries."""
        try:
            if self._is_local(sidx):
                ep = ctypes.c_uint64(0)
                live = ctypes.c_uint32(0)
                bitmap = (ctypes.c_uint8 * 1024)()
                n = load_lib().bps_server_members(
                    ctypes.byref(ep), ctypes.byref(live), bitmap, 1024)
                if n < 0:
                    return
                q_epoch, live_count = int(ep.value), int(live.value)
                bits = bytes(bitmap[:min(n, 1024)])
            else:
                q_epoch, live_count, bits = self._conn(sidx).members()
        except Exception as e:  # noqa: BLE001 - retried on the next op
            log.debug("membership query on server %d failed: %s", sidx, e)
            return
        q_epoch16 = q_epoch & 0xFFFF
        evicted_self = bool(self._worker_id < len(bits)
                            and bits[self._worker_id] == 0)
        with self._vlock:
            self._record_epoch_live(sidx, q_epoch16, int(live_count))
            seen = self._epoch_seen.get(sidx, 0)
            if (q_epoch16 == seen
                    or ((q_epoch16 - seen) & 0xFFFF) >= 0x8000):
                return
            self._epoch_seen[sidx] = q_epoch16
            self._live_pods = max(1, int(live_count))
        self._count("membership_events")
        log.warning("membership epoch %d adopted from server %d: %d live "
                    "worker(s)%s", q_epoch16, sidx, live_count,
                    "; this worker is evicted (it rejoins on its next push)"
                    if evicted_self else "")

    def _record_epoch_live(self, sidx: int, epoch16: int,
                           live: int) -> None:
        """Record (epoch -> live count) for ``sidx`` and prune the entries
        further than ``_EPOCH_LIVE_WINDOW`` epochs from it either way on
        the mod-2^16 ring (a one-sided test would strand entries a large
        jump left on the far half). Caller holds ``_vlock``."""
        self._epoch_live[(sidx, epoch16 & 0xFFFF)] = max(1, int(live))
        stale = [k for k in self._epoch_live if k[0] == sidx
                 and ((epoch16 - k[1]) & 0xFFFF) >= _EPOCH_LIVE_WINDOW
                 and ((k[1] - epoch16) & 0xFFFF) >= _EPOCH_LIVE_WINDOW]
        for k in stale:
            del self._epoch_live[k]

    def _live_at(self, sidx: int, epoch16: int) -> int:
        """The live count at ``epoch16`` on ``sidx``: the divisor of a round
        that closed under that epoch. An unknown epoch (the round's close
        is the first sign of the change) adopts the membership and looks
        again; the last resort is the adopted live count."""
        with self._vlock:
            v = self._epoch_live.get((sidx, epoch16))
        if v is not None:
            return v
        self._note_epoch(sidx)
        with self._vlock:
            return self._epoch_live.get((sidx, epoch16),
                                        max(1, self._live_pods))

    def last_round_live(self) -> Optional[int]:
        """The live count of the round this thread's last
        :meth:`pull_bytes` returned (None before any): that round's
        averaging divisor. Thread-local, as the connections are."""
        return getattr(self._tls, "round_live", None)

    def last_pull_round(self) -> Optional[int]:
        """The round this thread's last :meth:`pull_bytes` was served from
        (None before any); requested - served is its staleness."""
        return getattr(self._tls, "round_served", None)

    def sync_rounds(self, sidx: int) -> None:
        """Adopt server ``sidx``'s per-key round watermarks and store sizes
        (max-merge, :meth:`adopt_rounds`): the server's replay watermark
        outlives an eviction or a restart, and a fresh counter would mint
        rounds it drops as replays."""
        trips = self._conn(sidx).rounds()
        self.adopt_rounds({int(k): int(v) for k, v, _ in trips},
                          {int(k): int(nb) for k, _, nb in trips})

    def rejoin(self) -> None:
        """Re-register with every live server after an eviction (or a
        restart against a running tier): a heartbeat with the worker id
        re-admits it and bumps the epoch, then the round watermarks are
        adopted. Runs in line when a push is refused as evicted; a server
        that cannot be reached is left to its own failover."""
        with self._vlock:
            live = sorted(self._live)
        for sidx in live:
            try:
                self.ping(sidx)
                self.sync_rounds(sidx)
                self._note_epoch(sidx)
            except Exception as e:  # noqa: BLE001 - see the docstring
                log.warning("rejoin against server %d failed: %s: %s",
                            sidx, type(e).__name__, e)
        self._count("rejoins")

    def join(self) -> int:
        """Mid-stream admission (kJoin) on every live server: a fresh worker
        id grows the server's membership, an evicted one comes back; the
        epoch bumps (peers adopt it on their next op), rounds open at
        admission close over their contributors, and this worker adopts
        the round watermarks, so its first mint continues at the served
        frontier. Returns the number of servers that admitted it; raises
        :class:`NoLiveServersError` if none did."""
        with self._vlock:
            live = sorted(self._live)
        joined = []
        for sidx in live:
            try:
                if self._is_local(sidx):
                    rc = int(load_lib().bps_server_join(self._worker_id))
                    if rc < 0:
                        raise RuntimeError(f"local join failed (rc={rc})")
                else:
                    self._conn(sidx).join(self._worker_id)
                self.sync_rounds(sidx)
                self._note_epoch(sidx)
                joined.append(sidx)
            except Exception as e:  # noqa: BLE001 - as rejoin: the live
                # quorum admits; a dead server re-admits through the
                # eviction and in-line rejoin once it is back
                log.warning("join against server %d failed: %s: %s",
                            sidx, type(e).__name__, e)
        if not joined:
            raise NoLiveServersError(
                f"worker {self._worker_id} could not join any summation "
                "server")
        self._count("joins")
        log.info("worker %d joined mid-stream via server(s) %s",
                 self._worker_id, joined)
        return len(joined)

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
            c = self._connect(sidx)
            pool[sidx] = c
            with self._conn_lock:
                self._all_conns.append(c)
        return c

    def _connect(self, sidx: int) -> NativeClient:
        """Connect within the worker's connect budget, in slices, giving
        up early once the worker shuts down or ``sidx`` is failed over."""
        if self._closed:
            raise RuntimeError("PSWorker is shut down")
        host, port = self._servers[sidx]
        end = time.monotonic() + self._timeout / 1e3
        while True:
            left = int((end - time.monotonic()) * 1e3)
            try:
                return NativeClient(host, port,
                                    max(1, min(left, _CONNECT_SLICE_MS)),
                                    self._recv_timeout)
            except ConnectionError:
                if (left <= _CONNECT_SLICE_MS or sidx not in self._live
                        or self._closed):
                    raise

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

    def _is_local(self, sidx: int) -> bool:
        """``sidx`` is the server of this process and IPC is on."""
        return self._ipc and sidx == _INPROC_SERVER_ID

    # -- retry engine -------------------------------------------------------
    def _retry_loop(self, op: str, key: int, attempt_fn):
        """Drive ``attempt_fn(sidx) -> result`` under the per-op retry
        budget (``BYTEPS_RETRY_LIMIT``). Placement is re-resolved every
        attempt, so an op whose key moved since the first attempt aborts
        with :class:`FailedOverError` (its round numbering died with the
        old server: the stage retry re-runs it with a fresh version), and
        one with no live server left raises :class:`NoLiveServersError`.
        A server that never saw the key ("before init", a remap target)
        gets it re-inited from its recorded size.

        Backoff: ``BYTEPS_RETRY_BACKOFF_MS`` × 2^attempt, capped at 2 s,
        with seeded jitter in [0.5, 1.0] — the standard exponential
        backoff + jitter that keeps a retry storm from re-synchronizing
        every worker onto the recovering server."""
        sidx0 = self.server_for(key)
        m_att = self._m_attempts.get(op)
        attempt = 0
        while True:
            with self._vlock:
                live = set(self._live)
                epoch = self._epoch
            if not live:
                raise NoLiveServersError(
                    f"{op} key {key}: every summation server is dead")
            sidx = self._server_for_live(key, live)
            if sidx != sidx0:
                raise FailedOverError(
                    f"{op} key {key}: placement moved {sidx0}->{sidx} "
                    f"(failover epoch {epoch}); round abandoned")
            if m_att is not None:
                m_att[0].inc()
                m_att[1].inc()
            try:
                result = attempt_fn(sidx)
                self._note_epoch(sidx)
                return result
            except BaseException as e:  # noqa: BLE001 - classified below
                self._note_epoch(sidx)
                if isinstance(e, WorkerEvictedError):
                    # the server refuses this worker until it rejoins:
                    # rejoin here, then raise stage-retryably; the op's
                    # pinned round predates the adopted watermarks, so the
                    # stage retry mints afresh (the push stages drop the
                    # pin on this error)
                    log.warning("%s key %d refused: worker %d evicted; "
                                "rejoining", op, key, self._worker_id)
                    self.rejoin()
                    raise
                if (isinstance(e, RuntimeError) and "before init" in str(e)
                        and key in self._key_nbytes
                        and attempt < self._retry_limit):
                    # a failover target that never saw this key: re-init it
                    # from the recorded size and go again (init is
                    # idempotent server-side)
                    attempt += 1
                    self._count("reinits")
                    self._conn(sidx).init_key(key, self._key_nbytes[key])
                    continue
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

    # -- owner handoff (a pod of several controllers) -------------------------
    def fence(self) -> None:
        """Refuse every later round mint on this worker. Set when its owner
        is declared dead, before :meth:`export_rounds` snapshots the
        counters: a push thread that resolved this owner before the
        failover could otherwise mint a round after the snapshot, unseen
        by the survivors, whose re-mint of the same number the server's
        replay dedupe would then drop. The :class:`FailedOverError` is
        stage-retryable: the re-run resolves the owner afresh."""
        with self._vlock:
            self._fenced = True

    def export_rounds(self) -> Tuple[Dict[int, int], Dict[int, int]]:
        """(round counter, store size) per key: what a surviving
        controller adopts when this worker's owner dies."""
        with self._vlock:
            return dict(self._versions), dict(self._key_nbytes)

    def adopt_rounds(self, versions: Dict[int, int],
                     nbytes: Dict[int, int]) -> None:
        """Take a dead owner's round counters (the larger of the two per
        key) and store sizes. Unlike a server failover, the server and its
        per-(worker, key) replay watermark survive an owner's death, and
        all of a pod's controllers push under the pod's worker id, so a
        survivor must continue the pod's round numbering: a fresh counter
        would mint rounds at or below the watermark, dropped as replays.
        A round the dead owner pushed but did not pull stays replayable:
        the stage retry re-sends its pinned version through this worker,
        and the dedupe recognizes it."""
        with self._vlock:
            for k, v in versions.items():
                if v > self._versions.get(k, 0):
                    self._versions[k] = v
            for k, nb in nbytes.items():
                self._key_nbytes.setdefault(k, nb)

    # -- data plane ---------------------------------------------------------
    def init_key(self, key: int, nbytes: int) -> None:
        """Size key's f32 store on its server (idempotent server-side); the
        size is kept for a re-init on a failover target."""
        with self._vlock:
            self._key_nbytes[key] = int(nbytes)
        if self._is_local(self.server_for(key)):
            rc = load_lib().bps_local_init(key, nbytes)
            if rc != 0:
                check_local(rc, "init")
            return

        def attempt(s):
            # 'init'/server-scoped rules only (down windows, init-ack
            # loss): push/pull loss rules target the data plane proper
            inj = self._inject_pre("init", s)
            self._conn(s).init_key(key, nbytes)
            if inj is not None and inj.kind == "timeout":
                # the init WAS applied (and is idempotent); lose the ack
                self._kill_conn(s)
                raise InjectedTimeout(
                    f"injected: init ack for key {key} lost (server {s})")

        self._retry_loop("init", key, attempt)

    def mint_version(self, key: int, pinned: Optional[int] = None) -> int:
        """Reserve the round number a push will carry, BEFORE the wire
        attempt — the push stage pins it on its task so a stage retry
        re-sends the SAME round even when the first attempt died before
        ``push_bytes`` could return it. Re-sending the pinned round is
        safe in both failure modes: never-applied → the server sums it as
        round v; applied-but-ack-lost → the (worker, key, version) dedupe
        drops it. A pin beyond the counter (it predates a failover's
        counter reset) is discarded and a fresh round minted, exactly like
        ``push_bytes``'s own rule. A fenced worker (its owner failed
        over) refuses with :class:`FailedOverError`."""
        with self._vlock:
            if self._fenced:
                raise FailedOverError(
                    f"owner worker fenced (failed over); re-resolve the "
                    f"owner for key {key}")
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
        crc = (wire_crc32(b) if self._crc
               and not self._is_local(self.server_for(key)) else 0)

        def attempt(sidx):
            if self.pacer is not None:
                # book the payload's transmission time on the emulated NIC
                # BEFORE the wire op (every re-send pays wire time again,
                # as it would on a real NIC; the IPC path too: a
                # colocated deployment being modelled still crosses one)
                self.pacer.throttle_send(int(b.nbytes))
            if self._is_local(sidx):
                rc = load_lib().bps_local_push2(
                    self._worker_id, key, codec, version, b.ctypes.data,
                    b.nbytes)
                if rc != 0:
                    check_local(rc, f"push of key {key}")
                return
            inj = self._inject_pre("push", sidx)
            send = b
            if inj is not None and inj.kind == "corrupt":
                # the CRC was computed on the pristine payload: the flipped
                # byte is detected server-side and never summed
                send = b.copy()
                FaultPlan.corrupt(send.view(np.uint8).reshape(-1),
                                  inj.corrupt_at)
            self._conn(sidx).push(key, send, codec, self._worker_id,
                                  version, crc)
            if inj is not None and inj.kind == "timeout":
                # the push WAS applied; lose the ack, and the retry's
                # re-send exercises the dedupe
                self._kill_conn(sidx)
                raise InjectedTimeout(
                    f"injected: push ack for key {key} lost "
                    f"(server {sidx})")

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
            if self._is_local(sidx):
                ep = ctypes.c_uint64(0)
                served = ctypes.c_uint64(0)
                got = load_lib().bps_local_pull3(
                    key, codec, version, self._recv_timeout,
                    out.ctypes.data, out.nbytes, ctypes.byref(ep),
                    ctypes.byref(served))
                if got < 0:
                    check_local(got, f"pull of key {key}")
                if self.pacer is not None:
                    self.pacer.throttle_recv(int(got))
                self._tls.round_live = self._live_at(
                    sidx, int(ep.value) & 0xFFFF)
                self._tls.round_served = int(served.value)
                return out, int(got)
            inj = self._inject_pre("pull", sidx)
            conn = self._conn(sidx)
            got, resp_crc = conn.pull(
                key, out, version, codec, want_crc=self._crc,
                worker_id=self._worker_id)
            if self.pacer is not None:
                # book the response's transmission time per ATTEMPT: a lost
                # or corrupted response still crossed the emulated NIC
                self.pacer.throttle_recv(int(got))
            if inj is not None:
                if inj.kind == "timeout":
                    self._kill_conn(sidx)
                    raise InjectedTimeout(
                        f"injected: pull response for key {key} lost "
                        f"(server {sidx})")
                if inj.kind == "corrupt" and got > 0:
                    FaultPlan.corrupt(out[:got], inj.corrupt_at)
            if resp_crc and wire_crc32(out[:got]) != resp_crc:
                raise WireCorruption(
                    f"pull response for key {key} failed CRC "
                    f"(server {sidx}); retrying")
            # the response carries the epoch its round closed under: that
            # epoch's live count divides the round, whatever the current
            # membership is by now
            self._tls.round_live = self._live_at(sidx,
                                                 conn.last_pull_epoch())
            self._tls.round_served = conn.last_pull_round()
            return out, int(got)

        out, got = self._retry_loop("pull", key, attempt)
        with self._vlock:
            self.bytes_pulled += got
        self._m_pull_bytes.inc(got)
        self._m_pull_bytes_nic.inc(got)
        served = self._tls.round_served
        if version > 0:
            self._m_staleness.observe(max(0, int(version) - served))
            with self._vlock:
                # under staleness, a straggler served a round newer than it
                # asked for adopts it (max-merge), so that its next push
                # targets the open round instead of rounds the server
                # consumes silently; in strict sync served == requested
                # <= the counter, and nothing changes
                if (self._staleness > 0
                        and served > self._versions.get(key, 0)):
                    self._versions[key] = served
                minted = self._versions.get(key, int(version))
            ahead = max(0, int(minted) - served)
            self._m_rounds_ahead.set(ahead)
            self._m_rounds_ahead_nic.set(ahead)
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
        """Global worker barrier through the lowest live server (server 0
        while healthy — reference: ps-lite Postoffice::Barrier via the
        scheduler; after a failover the survivors host it)."""
        with self._vlock:
            sidx = min(self._live) if self._live else 0
        self._conn(sidx).barrier(self._worker_id)

    def ping(self, sidx: int = 0) -> Tuple[int, int]:
        """(server CLOCK_REALTIME ns, rtt ns) of one probe of ``sidx``; an
        injected down window fails it, as it fails the health monitor's.
        It carries the worker id: a lease heartbeat, and the re-admission
        of an evicted worker."""
        self._inject_pre("ping", sidx)
        return self._conn(sidx).ping(self._worker_id)

    def close(self) -> None:
        """Stop the health monitor and drop every connection WITHOUT the
        goodbye (a process that dies says none)."""
        if self._closed:
            return
        self._closed = True
        if self._health is not None:
            self._health.stop(join=True)
        self._drop_conns()

    def _drop_conns(self) -> None:
        with self._conn_lock:
            conns = list(self._all_conns)
            self._all_conns.clear()
        for c in conns:
            c.close()
        self._tls.conns = {}

    def shutdown(self) -> None:
        """Tell every server this worker is done (a server exits once all
        workers said so), then drop every connection."""
        if self._closed:
            return
        self._closed = True
        if self._health is not None:
            # joined (bounded by the monitor's short probe timeouts) before
            # the teardown: a fail_over it triggers must not race it
            self._health.stop(join=True)
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
                # (it stops itself once every worker said goodbye, and a
                # fault may have killed it): debug, with the index of the
                # server that missed its count
                log.debug("shutdown of server %d failed: %s: %s",
                          sidx, type(e).__name__, e)
        self._drop_conns()

    def get_counters(self) -> Dict[str, int]:
        """The robustness counters (retries, timeouts, connection and CRC
        errors, re-inits, give-ups, failovers, degraded fallbacks,
        membership events, rejoins, joins) and the adopted live pods, the
        plan's injected counts by kind (``injected_<kind>``) when a fault
        plan is armed, and the health monitor's miss counts and last probe
        age when it runs."""
        with self._counter_lock:
            out = dict(self.counters)
        out["live_pods"] = self.live_pods()
        if self._plan is not None:
            for k, v in self._plan.counters().items():
                out[f"injected_{k}"] = v
        if self._health is not None:
            out.update(self._health.debug_counters())
        return out


class _HealthMonitor:
    """Marks servers dead after ``miss_limit`` consecutive missed pings.

    Built on the kPing probe, on the monitor's OWN connections with short
    connect/recv timeouts (scaled to the probe interval): they are never
    shared with, or torn down by, the data plane, so a probe in flight
    during ``PSWorker.shutdown`` cannot race a freed native client, and a
    hung server costs one bounded probe, not the data plane's long recv
    timeout. The reference analog is ps-lite's scheduler heartbeat; every
    worker monitors on its own, and the failover barrier aligns their
    live sets. Injected ``server<N>`` windows fail the probe through the
    worker's plan (``_inject_pre('ping', ...)``), so the monitor's pings
    tick the plan too.
    """

    def __init__(self, worker: "PSWorker", interval_ms: int,
                 miss_limit: int):
        self._worker = worker
        self._interval = max(1, interval_ms) / 1e3
        # probe timeout: generous against the interval, small against the
        # data plane's recv timeout
        self._probe_ms = max(500, 4 * interval_ms)
        self._miss_limit = miss_limit
        self._misses: Dict[int, int] = {}
        # stall reports: per-server cumulative misses and the monotonic
        # time of the last finished probe, under _dbg_lock so a reader
        # never iterates a dict the monitor is changing
        self._total_misses: Dict[int, int] = {}
        self._last_probe: Dict[int, float] = {}
        self._dbg_lock = threading.Lock()
        self._m_misses = get_registry().counter("health.misses")
        self._conns: Dict[int, NativeClient] = {}
        self._stop_ev = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="bps-health", daemon=True)

    def debug_counters(self) -> Dict[str, int]:
        """Per-server consecutive and cumulative miss counts and the age
        of the newest probe: a stall report shows whether the monitor was
        looking, and how close each server sat to the miss limit."""
        now = time.monotonic()
        out: Dict[str, int] = {}
        with self._dbg_lock:
            for sidx, n in sorted(self._misses.items()):
                out[f"health_consec_miss_s{sidx}"] = n
            for sidx, n in sorted(self._total_misses.items()):
                out[f"health_misses_s{sidx}"] = n
            if self._last_probe:
                age = now - max(self._last_probe.values())
                out["health_last_probe_age_ms"] = int(age * 1e3)
        return out

    def start(self) -> None:
        self._thread.start()

    def stop(self, join: bool = False) -> None:
        self._stop_ev.set()
        if join and self._thread.is_alive():
            # bounded: one probe and one bounded failover barrier, both on
            # probe timeouts
            self._thread.join(timeout=2 * self._probe_ms / 1e3 + 5.0)

    def _probe(self, sidx: int) -> None:
        self._worker._inject_pre("ping", sidx)
        c = self._conns.get(sidx)
        if c is None or c.is_dead():
            if c is not None:
                c.close()
            host, port = self._worker._servers[sidx]
            c = NativeClient(host, port, self._probe_ms, self._probe_ms)
            self._conns[sidx] = c
        c.ping(self._worker._worker_id)

    def _run(self) -> None:
        try:
            while not self._stop_ev.wait(self._interval):
                if self._worker.is_wedged():
                    # a dead or wedged process pings nothing
                    continue
                for sidx in sorted(self._worker.live_servers()):
                    if self._stop_ev.is_set():
                        return
                    try:
                        self._probe(sidx)
                        with self._dbg_lock:
                            self._last_probe[sidx] = time.monotonic()
                            self._misses[sidx] = 0
                    except WorkerKilledError:
                        return  # injected process death: no more probes
                    except Exception as e:  # noqa: BLE001 - a miss
                        self._m_misses.inc()
                        with self._dbg_lock:
                            self._last_probe[sidx] = time.monotonic()
                            n = self._misses.get(sidx, 0) + 1
                            self._misses[sidx] = n
                            self._total_misses[sidx] = (
                                self._total_misses.get(sidx, 0) + 1)
                        log.debug(
                            "heartbeat miss %d/%d for server %d (%s)",
                            n, self._miss_limit, sidx, e)
                        if n >= self._miss_limit:
                            self._fail_over(sidx)
        finally:
            for c in self._conns.values():
                c.close()

    def _fail_over(self, sidx: int) -> None:
        """Failover with a BOUNDED alignment barrier: the data-plane
        barrier waits on the worker's long recv timeout, which would hold
        this thread (and a joining shutdown) for tens of seconds, so it
        takes a probe-timeout connection of its own instead, and a laggard
        peer makes the barrier best-effort (as fail_over's own is)."""
        if not self._worker.fail_over(sidx, barrier=False):
            return
        live = self._worker.live_servers()
        if not live:
            return
        try:
            host, port = self._worker._servers[min(live)]
            c = NativeClient(host, port, self._probe_ms, self._probe_ms)
            try:
                c.barrier()
            finally:
                c.close()
        except Exception as e:  # noqa: BLE001 - best-effort alignment
            log.warning("failover barrier (monitor) failed: %s", e)
