"""Deterministic DCN fault injection (``BYTEPS_FAULT_SPEC``) — the port's
own copy of ``byteps_tpu/common/faults.py``.

The reference stack survives real DCN weather — slow servers, dropped
connections, stragglers — because ps-lite carries retry/resend machinery
under BytePS. The port carries the matching *emulated failure surface* so
the self-healing data plane (PSWorker retries, scheduler stage retries,
health failover, degraded fallback) can be exercised deterministically on
loopback: application-level like the bandwidth pacer
(``server/pacer.py``), no root/netem/tc, one plan per PSWorker,
reproducible from a seed. Every scope and kind parses, renders and plans
exactly as the reference's; the port's PSWorker consumes the wire scopes
(push, pull, all, init, server<N>) and the worker scopes' kill, hang,
slow, join (the mid-stream admission, once, when the plan's step first
enters the window: ``PSWorker.join``) and the loss kinds. The serve
tier consumes the replica and tenant scopes: ``serve.Scheduler`` ticks
its plan once an iteration (op ``serve``; ``kill`` kills the replica,
``hang`` stalls it) and, with tenant rules, once per waiting tenant
(``slow`` delays the tenant's admission, ``hang`` defers it); the KV
wire's pushes tick op ``push``, as do the socket NIC's requests
(``common/socknic.py``). The proc scope is the launcher's: its
``Supervisor`` ticks a child's plan once a poll (op ``proc``; ``kill``
and ``restart`` become a real SIGKILL, ``restart`` also respawns).

Spec grammar (semicolon-separated rules)::

    BYTEPS_FAULT_SPEC = rule (';' rule)*
    rule   = scope ':' kind ['@' cond (',' cond)*]
    scope  = 'push' | 'pull' | 'init' | 'all' | 'server<N>' | 'worker'
           | 'worker<N>' | 'replica' | 'replica<N>' | 'tenant<T>'
           | 'proc' | 'proc<N>'
             # push/pull/all match DATA-PLANE ops only ('all' = push+pull);
             # 'init' matches key-init attempts only (kill = the init
             # never reached the server; timeout = applied, ack lost);
             # server<N> matches every op against that server, including
             # init and the health monitor's pings; 'worker' targets THIS
             # worker process itself (peer-death simulation): kill = the
             # worker dies at that plan op (every later op fails
             # WorkerKilledError, heartbeats stop — the server lease
             # evicts it); hang = the worker wedges for ms= milliseconds
             # (ops block then time out, heartbeats stop) and then may
             # rejoin; worker<N> is the worker scope RESTRICTED to the
             # plan whose worker_id is N — the same spec string is handed
             # to every worker, so 'worker1:slow@ms=80' makes exactly
             # worker 1 a deterministic straggler (every one of its wire
             # attempts pays 80 ms) while its peers run clean — the
             # bounded-staleness bench's slow-worker leg; 'replica' /
             # 'replica<N>' are the SERVE-tier twins: they match only
             # the serve scheduler's per-iteration intercept (op
             # 'serve'), never wire ops, so one spec string handed to
             # every component kills/wedges/slows exactly one serve
             # replica (replica<N> requires the plan's worker_id == N)
             # — the disaggregation tests' deterministic
             # decode-target-death and mid-migration-death legs
             # (docs/serving.md §disaggregation); 'tenant<T>' is the
             # multi-tenant twin: it matches only tenant-ATTRIBUTED
             # serve intercepts (the scheduler's admission attempts
             # for tenant T, made only when tenant rules exist), kinds
             # slow|hang only — 'tenant3:slow@ms=40' makes exactly
             # tenant 3's admissions pay 40 ms while its siblings run
             # clean, the deterministic noisy-tenant flood leg
             # (docs/serving.md §multi-tenant); 'proc' / 'proc<N>' are
             # the LAUNCHER-SUPERVISOR twins (byteps_tpu/launcher.py):
             # they match only the supervisor's per-child plan tick (op
             # 'proc', one tick per Supervisor.poll per child), never
             # wire or serve ops — and unlike every emulated kind the
             # supervisor executes them as REAL OS signals against real
             # child processes: kill = SIGKILL the child (its silence
             # trips the server lease eviction exactly as a real crash
             # would), restart = SIGKILL + respawn through the bounded
             # restart-with-backoff path; proc<N> requires the child
             # plan's worker_id == N, same convention as worker<N>
    kind   = 'timeout' | 'kill' | 'slow' | 'corrupt' | 'down' | 'hang'
           | 'join' | 'restart'
             # 'restart' (proc/proc<N> scopes only): the supervisor
             # SIGKILLs the child and immediately respawns it (counted
             # against the restart budget) — the crash-resume drill
             # 'join' (worker/worker<N> scopes only, deterministic —
             # requires step=, no p=): the worker runs the kJoin
             # mid-stream admission handshake (PSWorker.join: admission
             # + round-watermark adoption) once, when its plan step
             # first enters the window, then the intercepted op
             # proceeds under the adopted membership — the churn
             # bench/tests schedule deterministic mid-stream joins with
             # 'worker<N>:join@step=A'
    cond   = 'p=' FLOAT          # per-op Bernoulli (seeded RNG)
           | 'op=' A ['..' [B]]  # plan-op window, inclusive; open end ok
           | 'step=' ...         # alias of op=
           | 'ms=' INT           # slow/hang: injected latency
                                 # (default 50 slow / 300000 hang)

Examples: ``push:timeout@p=0.05`` — 5% of push attempts lose their
response; ``server1:down@step=40..55`` — every op against server 1 fails
while the plan step is in [40, 55]; ``pull:corrupt@p=0.01`` — 1% of pull
responses get a byte flipped (the CRC32 in the wire frame detects it and
the retry engine re-pulls).

Semantics the consumers rely on:

* **step/op counter** — ticks once per *intercepted wire attempt*
  (including retries), per plan. This is what makes a transient ``down``
  window survivable by pure retry/backoff: each failed attempt advances
  the counter, so a 15-step window expires after at most ~15 attempts
  even when nothing else makes progress. It is NOT the training step.
* **timeout** — the op is performed for real and only then reported as a
  recv timeout (models a lost *response*: the server applied the push).
  This is the path that proves the server's (worker, key, version) replay
  dedupe — the retry re-sends a push the server already summed.
* **kill** — the op never happens (connection dies before the request
  leaves); the injector kills the live socket so the next attempt
  reconnects.
* **corrupt** — a byte of the payload is flipped *after* the CRC was
  computed (push) or *before* it is verified (pull), so the corruption is
  always detected, never silently summed.
* **down** — every op in scope fails with a connection error while the
  window is active (and the socket is killed), emulating a dead/unreachable
  server process.

Determinism: one ``random.Random(seed * 1000003 + worker_id)`` per plan,
advanced only by probability rules, under a lock. Single-threaded
workloads replay exactly; multi-threaded ones are reproducible up to op
interleaving (same as the reference's real network, minus the physics).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from byteps_tpu_torch.common.logging import get_logger

log = get_logger("faults")

__all__ = [
    "FaultRule", "FaultPlan", "Injection", "InjectedTimeout",
    "InjectedConnectionError", "ServerDownError", "WorkerKilledError",
    "parse_fault_spec", "rules_to_spec", "plan_from_env", "churn_events",
]

KINDS = ("timeout", "kill", "slow", "corrupt", "down", "hang", "join",
         "restart")
SCOPES = ("push", "pull", "all", "init", "worker", "replica", "tenant",
          "proc")


class InjectedTimeout(TimeoutError):
    """Injected recv timeout — the response (not the request) was lost."""


class InjectedConnectionError(ConnectionError):
    """Injected connection kill — the request never reached the server."""


class ServerDownError(ConnectionError):
    """Injected server-down window: the server is unreachable."""


class WorkerKilledError(RuntimeError):
    """Injected worker death (``worker:kill``): THIS worker process is
    simulated dead — every wire op fails with this error and heartbeats
    stop, so the server's lease eviction fires exactly as it would for a
    real crash. Never retryable: a dead process retries nothing."""

    retryable = False


@dataclasses.dataclass(frozen=True)
class FaultRule:
    scope: str                 # one of SCOPES, or 'server<N>'
    kind: str                  # one of KINDS
    p: Optional[float] = None  # per-op probability (None = always/window)
    window: Optional[Tuple[int, Optional[int]]] = None  # [a, b] op window
    latency_ms: int = 50       # for kind == 'slow' / 'hang'
    server: Optional[int] = None  # parsed from 'server<N>' scopes
    # parsed from 'worker<N>' / 'replica<N>' / 'proc<N>' scopes: the
    # rule only fires on the plan whose worker_id is N (the shared spec
    # string selects ONE worker/replica/child); None = the bare scope,
    # every plan
    worker: Optional[int] = None
    # parsed from 'tenant<T>' scopes (serve tier, docs/serving.md
    # §multi-tenant): the rule fires only on tenant-attributed serve
    # intercepts whose tenant id stringifies to T — never on the
    # replica-level per-iteration intercept (tenant=None), so a spec
    # carrying both replica and tenant rules keeps each family's step
    # windows independent
    tenant: Optional[str] = None

    def to_spec(self) -> str:
        """Render back to the BYTEPS_FAULT_SPEC grammar (round-trip:
        ``parse_fault_spec(rule.to_spec())`` reproduces the rule)."""
        conds = []
        if self.p is not None:
            conds.append(f"p={self.p}")
        if self.window is not None and self.window != (0, None):
            a, b = self.window
            conds.append(f"op={a}" if b == a else
                         f"op={a}.." + ("" if b is None else str(b)))
        if self.latency_ms != (300000 if self.kind == "hang" else 50):
            conds.append(f"ms={self.latency_ms}")
        if self.scope == "tenant":
            head = f"tenant{self.tenant}:{self.kind}"
        elif (self.scope in ("worker", "replica", "proc")
                and self.worker is not None):
            head = f"{self.scope}{self.worker}:{self.kind}"
        else:
            head = f"{self.scope}:{self.kind}"
        return head + ("@" + ",".join(conds) if conds else "")

    def matches(self, op: str, sidx: int, step: int, rng,
                worker_id: Optional[int] = None,
                tenant: Optional[str] = None) -> bool:
        if self.server is not None:
            # server scopes hit EVERY op against that server — data plane,
            # init, and the health monitor's pings (that is what lets a
            # 'down' window trip the monitor)
            if sidx != self.server:
                return False
        elif self.scope == "worker":
            # worker scopes simulate THIS process's death/wedge/slowness,
            # so they match every wire attempt regardless of target
            # server or op; a worker<N> scope additionally requires the
            # plan to BE worker N (per-worker straggler targeting)
            if self.worker is not None and worker_id != self.worker:
                return False
        elif self.scope == "replica":
            # replica scopes target ONE serve replica's scheduler loop
            # (op 'serve', ticked once per Scheduler.step) and nothing
            # else — a spec string shared with PSWorkers/wires can
            # never make the data plane pay a replica's death; they
            # also never fire on tenant-ATTRIBUTED intercepts, so
            # mixing replica and tenant rules in one spec keeps the
            # replica rules' step-window pins stable
            if op != "serve" or tenant is not None:
                return False
            if self.worker is not None and worker_id != self.worker:
                return False
        elif self.scope == "tenant":
            # tenant scopes fire ONLY on tenant-attributed serve
            # intercepts (the scheduler's admission attempts for that
            # tenant, and only when the plan carries tenant rules at
            # all — so tenant-free specs never see extra step ticks)
            if op != "serve" or tenant is None:
                return False
            # the grammar lowercases the whole rule head, so tenant
            # ids match case-insensitively
            if tenant.lower() != self.tenant:
                return False
        elif self.scope == "proc":
            # proc scopes target ONE supervised child process's plan
            # tick (op 'proc', ticked once per Supervisor.poll) and
            # nothing else — a spec string shared with PSWorkers/wires
            # can never make the data plane pay a process kill, and a
            # child's own in-process plan never sees op 'proc' (the
            # SUPERVISOR owns these plans: a SIGKILLed process cannot
            # execute its own death)
            if op != "proc":
                return False
            if self.worker is not None and worker_id != self.worker:
                return False
        elif self.scope == "init":
            if op != "init":
                return False
        else:
            # push/pull/all scopes are DATA-PLANE only: loss specs must
            # not make the health monitor count injected ping misses and
            # fail over perfectly healthy servers
            if op not in ("push", "pull"):
                return False
            if self.scope != "all" and self.scope != op:
                return False
        if self.window is not None:
            a, b = self.window
            if step < a or (b is not None and step > b):
                return False
        if self.p is not None and rng.random() >= self.p:
            return False
        return True


@dataclasses.dataclass
class Injection:
    """What the interceptor decided for one wire attempt."""

    kind: str
    rule: FaultRule
    # for 'corrupt': which payload byte to flip (modulo the buffer size)
    corrupt_at: int = 0


def _parse_num(value: str, cast, what: str):
    """Cast a condition value, naming the grammar on failure instead of
    leaking a bare ``invalid literal for int()``."""
    try:
        return cast(value)
    except ValueError:
        raise ValueError(
            f"{what} (got {value!r}; grammar: docs/robustness.md)"
        ) from None


def parse_fault_spec(spec: str) -> List[FaultRule]:
    rules: List[FaultRule] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        try:
            head, _, conds = part.partition("@")
            scope, _, kind = head.partition(":")
            scope = scope.strip().lower()
            kind = kind.strip().lower()
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} (expected one of "
                    f"{'|'.join(KINDS)})")
            server = None
            worker = None
            tenant = None
            if scope.startswith("tenant"):
                ident = scope[len("tenant"):]
                if not ident:
                    raise ValueError(
                        "tenant scopes need the tenant id inline "
                        "(expected tenant<T>, e.g. tenant3:slow)")
                tenant = ident
                scope = "tenant"
            elif scope.startswith("server") and scope not in SCOPES:
                idx = scope[len("server"):]
                if not idx.isdigit():
                    # 'serverX:down' / 'server:down' must name the
                    # grammar, not surface a bare int() ValueError
                    raise ValueError(
                        f"bad server index {idx!r} in scope {scope!r} "
                        "(expected server<N>, e.g. server1)")
                server = int(idx)
            elif scope.startswith("worker") and scope not in SCOPES:
                idx = scope[len("worker"):]
                if not idx.isdigit():
                    raise ValueError(
                        f"bad worker index {idx!r} in scope {scope!r} "
                        "(expected worker<N>, e.g. worker1)")
                worker = int(idx)
                scope = "worker"
            elif scope.startswith("replica") and scope not in SCOPES:
                idx = scope[len("replica"):]
                if not idx.isdigit():
                    raise ValueError(
                        f"bad replica index {idx!r} in scope {scope!r} "
                        "(expected replica<N>, e.g. replica1)")
                worker = int(idx)
                scope = "replica"
            elif scope.startswith("proc") and scope not in SCOPES:
                idx = scope[len("proc"):]
                if not idx.isdigit():
                    raise ValueError(
                        f"bad proc index {idx!r} in scope {scope!r} "
                        "(expected proc<N>, e.g. proc1)")
                worker = int(idx)
                scope = "proc"
            elif scope not in SCOPES:
                raise ValueError(
                    f"unknown fault scope {scope!r} (expected one of "
                    f"{'|'.join(SCOPES)}, server<N>, worker<N>, "
                    "replica<N>, or proc<N>)")
            if scope == "proc" and kind not in ("kill", "restart"):
                raise ValueError(
                    "proc scopes take only kill|restart — the launcher "
                    "supervisor executes them as REAL signals against a "
                    "child process (kill = SIGKILL, restart = SIGKILL + "
                    "respawn); emulated wire weather belongs to the "
                    "child's own in-process plan")
            if kind == "restart" and scope != "proc":
                raise ValueError(
                    "'restart' is a supervisor action (SIGKILL + "
                    "respawn) and only takes the 'proc'/'proc<N>' "
                    "scopes (proc1:restart@p=0.1)")
            if kind == "hang" and scope not in ("worker", "replica",
                                                "tenant"):
                raise ValueError(
                    "'hang' simulates a worker/replica wedging and only "
                    "takes the 'worker'/'worker<N>'/'replica'/"
                    "'replica<N>'/'tenant<T>' scopes (worker:hang@...)")
            if scope == "tenant" and kind not in ("slow", "hang"):
                raise ValueError(
                    "tenant scopes take only slow|hang — a tenant is "
                    "traffic, not a process: it can be throttled "
                    "(slow = injected latency on its admission, hang = "
                    "its admission defers while the window is active) "
                    "but has no socket to kill or payload to corrupt")
            if scope == "replica" and kind not in ("kill", "hang", "slow"):
                raise ValueError(
                    "replica scopes take only kill|hang|slow — a serve "
                    "replica's step has no payload to corrupt or "
                    "response to lose (wire-leg faults belong to the "
                    "KVWire's own plan)")
            if kind == "join" and scope != "worker":
                raise ValueError(
                    "'join' is a mid-stream worker admission and only "
                    "takes the 'worker'/'worker<N>' scopes "
                    "(worker2:join@step=12)")
            p = None
            window = None
            latency_ms = 300000 if kind == "hang" else 50
            for cond in filter(None, (c.strip() for c in conds.split(","))):
                k, _, v = cond.partition("=")
                k = k.strip().lower()
                v = v.strip()
                if k == "p":
                    p = _parse_num(v, float,
                                   "p= needs a float probability")
                elif k in ("op", "step"):
                    a, dots, b = v.partition("..")
                    lo = _parse_num(a, int, f"{k}= needs an int op index")
                    hi = None if (dots and not b.strip()) else (
                        _parse_num(b, int, f"{k}= window end needs an int")
                        if dots else lo)
                    window = (lo, hi)
                elif k == "ms":
                    latency_ms = _parse_num(
                        v, int, "ms= needs an int millisecond latency")
                else:
                    raise ValueError(
                        f"unknown fault condition {k!r} (expected "
                        "p=|op=|step=|ms=)")
            if kind == "join" and (window is None or p is not None):
                # joins are a deterministic SCHEDULE, not weather: the
                # churn harness derives thread start/stop from the
                # windows, so a probabilistic or bare join is a spec bug
                raise ValueError(
                    "'join' fires deterministically: give a step= "
                    "window (e.g. worker2:join@step=12), not p=")
            if p is None and window is None:
                # bare rule: always fires (e.g. 'server1:down')
                window = (0, None)
            rules.append(FaultRule(scope=scope, kind=kind, p=p,
                                   window=window, latency_ms=latency_ms,
                                   server=server, worker=worker,
                                   tenant=tenant))
        except ValueError as e:
            raise ValueError(
                f"bad BYTEPS_FAULT_SPEC rule {part!r}: {e}") from None
    return rules


def rules_to_spec(rules: List[FaultRule]) -> str:
    """Inverse of :func:`parse_fault_spec` (each rule via
    :meth:`FaultRule.to_spec`) — pinned by the grammar round-trip test."""
    return ";".join(r.to_spec() for r in rules)


def churn_events(rules: List[FaultRule]) -> List[Tuple[int, int, str]]:
    """The deterministic membership SCHEDULE encoded by a spec's
    worker-scoped ``join``/``kill`` rules: ``[(step, worker_id, kind)]``
    sorted by window start. This is what a churn harness (the
    ``bench.py --mode chaos`` churn leg, elasticity tests) drives worker
    thread start/stop from — the same string each worker's plan parses,
    read once at the orchestration layer."""
    out = [
        (r.window[0], r.worker if r.worker is not None else -1, r.kind)
        for r in rules
        if r.scope == "worker" and r.kind in ("join", "kill")
        and r.window is not None
    ]
    return sorted(out)


class FaultPlan:
    """Seeded, per-worker fault schedule over the PSWorker wire boundary.

    One plan per PSWorker: ``intercept(op, sidx)`` is called once per wire
    attempt (push/pull/ping, retries included); it ticks the plan step,
    evaluates every rule, counts what fired, and returns at most one
    :class:`Injection` (first matching rule wins; ``slow`` additionally
    sleeps inline and keeps looking, so latency can compose with a loss).
    """

    def __init__(self, rules: List[FaultRule], seed: int = 0,
                 worker_id: int = 0):
        from byteps_tpu_torch.common.metrics import get_registry

        self.rules = list(rules)
        self.seed = seed
        self.worker_id = worker_id
        self._rng = random.Random(seed * 1000003 + worker_id)
        self._lock = threading.Lock()
        self._step = 0
        self.injected: Dict[str, int] = {k: 0 for k in KINDS}
        # always-on registry mirror: per-plan counts die with the plan's
        # PSWorker (owner failover retires it); the process-wide
        # faults.injected_* totals do not (docs/observability.md)
        _reg = get_registry()
        self._m_injected = {k: _reg.counter(f"faults.injected_{k}")
                            for k in KINDS}

    @property
    def step(self) -> int:
        return self._step

    def has_tenant_rules(self) -> bool:
        """True when the spec carries any ``tenant<T>:`` rule — the
        serve scheduler only makes tenant-attributed intercept calls
        (which tick the step counter) when this is set, so tenant-free
        specs keep their historical step-window alignment."""
        return any(r.scope == "tenant" for r in self.rules)

    def intercept(self, op: str, sidx: int,
                  tenant: Optional[str] = None) -> Optional[Injection]:
        """Decide the fate of one wire attempt; sleeps for 'slow' rules."""
        sleep_ms = 0
        hit: Optional[Injection] = None
        with self._lock:
            self._step += 1
            for r in self.rules:
                if not r.matches(op, sidx, self._step, self._rng,
                                 worker_id=self.worker_id,
                                 tenant=tenant):
                    continue
                if r.kind == "slow":
                    self.injected["slow"] += 1
                    self._m_injected["slow"].inc()
                    sleep_ms += r.latency_ms
                    continue  # latency composes with a later loss rule
                self.injected[r.kind] += 1
                self._m_injected[r.kind].inc()
                hit = Injection(kind=r.kind, rule=r,
                                corrupt_at=self._rng.randrange(1 << 30))
                break
        if sleep_ms:
            time.sleep(sleep_ms / 1e3)
        return hit

    @staticmethod
    def corrupt(buf, at: int) -> None:
        """Flip one byte of a writable uint8 buffer in place."""
        if len(buf) == 0:
            return
        i = at % len(buf)
        buf[i] = (int(buf[i]) ^ 0xFF) & 0xFF

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.injected)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"FaultPlan(seed={self.seed}, worker={self.worker_id}, "
                f"rules={self.rules})")


def plan_from_env(cfg=None, worker_id: int = 0) -> Optional[FaultPlan]:
    """FaultPlan from BYTEPS_FAULT_SPEC / BYTEPS_FAULT_SEED, or None."""
    if cfg is None:
        from byteps_tpu_torch.common.config import get_config

        cfg = get_config()
    spec = getattr(cfg, "fault_spec", "")
    if not spec:
        return None
    plan = FaultPlan(parse_fault_spec(spec),
                     seed=getattr(cfg, "fault_seed", 0),
                     worker_id=worker_id)
    log.info("fault injection armed for worker %d: %s", worker_id, spec)
    return plan
