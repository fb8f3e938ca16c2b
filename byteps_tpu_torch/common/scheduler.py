"""Credit-based priority scheduler — the ByteScheduler core (the port's
copy of ``byteps_tpu/common/scheduler.py``).

Equivalent of ``byteps/common/scheduled_queue.cc`` +
``byteps/common/core_loops.cc``. The reference runs ~12 background threads,
one per pipeline stage (COORDINATE_REDUCE → REDUCE → COPYD2H → ... → PUSH →
PULL → ... → BROADCAST), each popping the highest-priority ready partition
from a per-stage ``BytePSScheduledQueue``; the PUSH stage additionally
enforces a **credit** budget (at most ``BYTEPS_SCHEDULING_CREDIT`` partitions
in flight). What must be preserved is the *semantics* that made BytePS
fast (SURVEY §3.2 — "the single most important behavior to preserve"):

* partitions are issued **in priority order** (priority = -declaration
  order, ties broken by key), regardless of arrival order;
* at most ``credit`` partitions are in flight at once, so a late-arriving
  high-priority partition can still jump ahead of queued low-priority ones
  instead of sitting behind a fully-committed queue;
* completion frees a credit and immediately pumps the queue.

The scheduler is stage-generic: a pipeline is a list of named stages,
each with a function run on the stage's own thread pool. Each stage's
run and queue-dwell times land in the metrics registry as
``scheduler.stage.<NAME>.run_us`` / ``dwell_us``, and every
``StallError`` / ``PartitionFailure`` carries the flight recorder's
post-mortem (``common/flight_recorder.py``). The per-partition chrome
trace of the reference waits for the port's tracer.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from byteps_tpu_torch.common.flight_recorder import get_flight_recorder
from byteps_tpu_torch.common.logging import get_logger
from byteps_tpu_torch.common.metrics import get_registry
from byteps_tpu_torch.common.partition import Partition

log = get_logger("scheduler")


# --- stage-order registry ----------------------------------------------------
# Pipeline-order of every stage name any scheduler has declared, merged
# across pipelines (order-preserving: a new name is inserted after its
# predecessor in the registering sequence). Pipelines register at import
# time (``stage_orders``) AND every PipelineScheduler re-registers its
# actual stage list at construction, so a stage added to a constructor
# without updating the declared constant still lands in the order.
_stage_order: List[str] = []
_stage_order_lock = threading.Lock()

# sequential id per PipelineScheduler: the credit-occupancy gauge is a
# per-scheduler series — two concurrent schedulers (two DcnCores in one
# process) sharing one gauge would mask each other last-writer-wins
_SCHED_SEQ = itertools.count()


def register_stage_order(names: Sequence[str]) -> None:
    """Merge a pipeline's stage-name sequence into the global order:
    each new name lands after its last already-known predecessor in the
    registering sequence, or before its first known successor, or at the
    end (a pipeline unrelated to every existing one appends whole)."""
    seq = [str(n) for n in names]
    with _stage_order_lock:
        for i, n in enumerate(seq):
            if n in _stage_order:
                continue
            pred = -1
            for p in seq[:i]:
                if p in _stage_order:
                    pred = max(pred, _stage_order.index(p))
            if pred >= 0:
                _stage_order.insert(pred + 1, n)
                continue
            succ = None
            for q in seq[i + 1:]:
                if q in _stage_order:
                    succ = _stage_order.index(q)
                    break
            if succ is not None:
                _stage_order.insert(succ, n)
            else:
                _stage_order.append(n)


def registered_stage_order() -> List[str]:
    with _stage_order_lock:
        return list(_stage_order)


class StallError(TimeoutError):
    """A Handle.wait() that did not complete in time — including a wait
    capped by ``BYTEPS_HANDLE_DEADLINE_MS``, which turns a would-be
    infinite wait (a dead peer, a wedged server) into this diagnosable
    error. Carries which partitions completed and, when the owning
    pipeline attached a ``handle.diag`` callback, its counters at the
    moment of the stall (retries, failovers, live servers, health-probe
    ages, credit pools), so the report shows why retry or failover did or
    did not fire."""

    def __init__(self, handle_name: str, waited_s: Optional[float],
                 done_parts: List[int], total_parts: int,
                 diag: Optional[Dict[str, Any]] = None,
                 deadline_capped: bool = False):
        cap = (" (BYTEPS_HANDLE_DEADLINE_MS cap)" if deadline_capped
               else "")
        waited = "?" if waited_s is None else f"{waited_s:.1f}"
        super().__init__(
            f"handle '{handle_name}' stalled: {len(done_parts)}/"
            f"{total_parts} partition(s) done after {waited}s{cap}; "
            f"diagnostics: {diag if diag is not None else 'none attached'}")
        self.handle_name = handle_name
        self.done_parts = done_parts
        self.total_parts = total_parts
        self.diag = diag
        self.deadline_capped = deadline_capped
        # the flight recorder's post-mortem (the per-step ring and recent
        # FAULT events), attached at raise time by Handle.wait()
        self.post_mortem: Optional[Dict[str, Any]] = None


def capped_timeout(timeout: Optional[float]) -> Tuple[Optional[float], bool]:
    """``timeout`` (seconds, None = forever) under the
    ``BYTEPS_HANDLE_DEADLINE_MS`` cap, which bounds EVERY wait, so no
    configuration turns a dead peer into an infinite block; and whether
    the cap is what applies."""
    from byteps_tpu_torch.common.config import get_config

    deadline_ms = get_config().handle_deadline_ms
    if deadline_ms > 0 and (timeout is None or deadline_ms / 1e3 < timeout):
        return deadline_ms / 1e3, True
    return timeout, False


class PartitionFailure(RuntimeError):
    """A handle failed because one partition's pipeline failed.

    Names the failed partition and attaches the per-partition results that
    HAD completed when the failure froze the handle (``partial_results`` —
    a snapshot: later sibling completions do not mutate a failed handle).
    The original stage exception is ``__cause__``/``cause``.
    """

    def __init__(self, handle_name: str, part_idx: Optional[int],
                 cause: BaseException, partial_results: Dict[int, Any]):
        part = "?" if part_idx is None else str(part_idx)
        super().__init__(
            f"handle '{handle_name}' failed at partition {part}: "
            f"{type(cause).__name__}: {cause} "
            f"({len(partial_results)} sibling partition(s) completed)")
        self.handle_name = handle_name
        self.part_idx = part_idx
        self.cause = cause
        self.partial_results = partial_results
        self.__cause__ = cause
        # the flight recorder's post-mortem, attached by
        # Handle._partition_failed
        self.post_mortem: Optional[Dict[str, Any]] = None


class Handle:
    """Completion handle for one enqueued tensor (all its partitions).

    Reference analog: the int handle from ``HandleManager``
    (byteps/torch/handle_manager.cc); ``wait()`` is ``wait_and_clear``.

    Failure freezes the handle: the first ``_partition_failed`` snapshots
    the results collected so far into a :class:`PartitionFailure`, and
    every later sibling completion is dropped — ``wait()`` after failure
    must hand back a stable error, not a dict that sibling stage threads
    are still mutating underneath the caller.
    """

    def __init__(self, name: str, num_partitions: int) -> None:
        self.name = name
        self._num_partitions = num_partitions
        self._remaining = num_partitions
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self.results: Dict[int, Any] = {}  # part_idx -> stage-pipeline output
        # Optional stall-diagnostics callback attached by the owning
        # pipeline: () -> dict of counters, folded into the StallError a
        # timed-out wait() raises.
        self.diag: Optional[Callable[[], Dict[str, Any]]] = None
        self._stall_recorded = False  # one FAULT-ring event per handle

    def _partition_done(self, part_idx: int, result: Any) -> None:
        with self._lock:
            if self._error is not None:
                return  # failed handle is frozen
            self.results[part_idx] = result
            self._remaining -= 1
            if self._remaining <= 0:
                self._event.set()

    def _partition_failed(self, exc: BaseException,
                          part_idx: Optional[int] = None) -> None:
        with self._lock:
            if self._error is not None:
                return  # already failed and signalled
            err = self._error = PartitionFailure(
                self.name, part_idx, exc, dict(self.results))
        # the post-mortem rides the first failure: built outside the
        # handle lock, attached before the waiters wake, and its file
        # written after they did (a slow disk must not hold a waiter long
        # enough to misread the failure as a stall)
        fr = pm = None
        try:
            fr = get_flight_recorder()
            fr.record_event("partition_failure", {
                "handle": self.name, "part": part_idx,
                "error": type(exc).__name__})
            pm = fr.post_mortem(reason="partition_failure", dump=False)
            err.post_mortem = pm
        except Exception:  # noqa: BLE001 - telemetry must never mask
            pass           # the original failure
        finally:
            self._event.set()
        if fr is not None and pm is not None:
            try:
                fr.maybe_dump("partition_failure", pm)
            except Exception:  # noqa: BLE001
                pass

    def done(self) -> bool:
        return self._event.is_set()

    def failed(self) -> bool:
        return self._error is not None

    def error(self) -> Optional[BaseException]:
        """The failure that froze this handle, or None."""
        return self._error

    def wait(self, timeout: Optional[float] = None) -> Dict[int, Any]:
        effective, capped = capped_timeout(timeout)
        if not self._event.wait(effective):
            diag = None
            if self.diag is not None:
                try:
                    diag = self.diag()
                except Exception as e:  # noqa: BLE001 - diagnostics are
                    # best-effort; a failing callback must not mask the
                    # stall itself
                    diag = {"diag_error": f"{type(e).__name__}: {e}"}
            with self._lock:
                done = sorted(self.results)
            err = StallError(self.name, effective, done,
                             self._num_partitions, diag,
                             deadline_capped=capped)
            # the post-mortem rides every stall; its FAULT event is
            # recorded once a handle (poll-style waiters re-raise this
            # every slice and would evict the ring's real history)
            try:
                fr = get_flight_recorder()
                with self._lock:
                    first = not self._stall_recorded
                    self._stall_recorded = True
                if first:
                    fr.record_event("stall", {
                        "handle": self.name, "done": len(done),
                        "total": self._num_partitions,
                        "deadline_capped": capped})
                err.post_mortem = fr.post_mortem(reason="stall")
            except Exception:  # noqa: BLE001 - telemetry must never
                pass           # mask the stall itself
            raise err
        if self._error is not None:
            raise self._error
        return self.results


@dataclasses.dataclass
class Stage:
    """One pipeline stage (reference analog: one QueueType + its core loop).

    ``fn(task) -> result`` runs the stage. If ``credited`` the stage draws
    from the scheduler's credit budget while the task occupies it (the
    reference applies credits at PUSH). ``pool_size`` > 1 lets slow blocking
    stages (e.g. DCN push/pull waiting on sockets) overlap across partitions.

    ``releases_credit`` scopes the credit to the WIRE, not the pipeline:
    a task's credit frees when it exits this stage instead of at pipeline
    completion. The DCN pipeline sets it on PUSH so that partition
    i+credit can start pushing while partition i is still pulling or
    decompressing; credit then bounds concurrent *push occupancy* (the
    reference's BYTEPS_SCHEDULING_CREDIT bounds bytes in the push queue the
    same way). Default False keeps the hold-until-completion scope.

    ``retryable`` re-enqueues a failed task at THIS stage (priority
    preserved — it re-enters the same priority queue) instead of instantly
    failing the whole ``Handle``: up to ``max_attempts`` total tries with
    ``retry_backoff_s`` × 2^n backoff. While backing off, the task's
    credit (if held) is returned to the pool and re-acquired through the
    normal credited-stage gate when the retry is issued. Exceptions
    carrying ``retryable = False`` fail immediately. The DCN pipeline sets
    it on PUSH/PULL as the second line of defense above the PSWorker wire
    retries.
    """

    name: str
    fn: Callable[["PartitionTask"], Any]
    credited: bool = False
    pool_size: int = 1
    releases_credit: bool = False
    retryable: bool = False
    max_attempts: int = 3
    retry_backoff_s: float = 0.05


@dataclasses.dataclass
class PartitionTask:
    """A partition moving through the pipeline (reference: TensorTableEntry)."""

    partition: Partition
    name: str
    handle: Handle
    payload: Any = None        # stage functions read/replace this
    stage_idx: int = 0
    context: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # The aggregation ROUND this task belongs to (the tensor's version
    # counter at enqueue). Only consulted when the scheduler's
    # ``rounds_window`` is armed: a task may not issue while its key still
    # has a round more than ``window`` behind it in flight — the per-key
    # run-ahead bound that generalizes the credit gate from partitions to
    # rounds. None = ungated.
    round: Optional[int] = None
    # perf_counter of the last queue insertion (set by _StageQueue.push):
    # issue_time − queued_at is the stage DWELL the metrics registry
    # tracks per stage — queue wait is the quantity the priority
    # scheduler exists to control
    queued_at: float = 0.0
    # Credit ownership is PER-TASK state and must never live in
    # ``context``: the pipelines share one context dict across every
    # partition of a tensor, which would let partition 0's credit cover
    # its siblings.
    holds_credit: bool = False
    # The credit POOL this task's credit came from (owner-scoped credits):
    # recorded at acquire time so the release refunds the same pool even
    # if an owner failover re-routes the task's wire mid-flight.
    credit_pool: int = 0
    # Tries consumed at the CURRENT stage (Stage.retryable); reset to 0
    # when the task advances, so each stage gets its own budget.
    stage_attempts: int = 0

    @property
    def sort_key(self):
        # Max-priority first; ties by key (reference sorts by (priority, key)).
        return (-self.partition.priority, self.partition.key)


class _StageQueue:
    """Priority queue for one stage (reference: BytePSScheduledQueue)."""

    def __init__(self) -> None:
        self._heap: List = []
        self._counter = 0

    def push(self, task: PartitionTask) -> None:
        task.queued_at = time.perf_counter()
        self._counter += 1
        heapq.heappush(self._heap, (task.sort_key, self._counter, task))

    def pop(self) -> Optional[PartitionTask]:
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[2]

    def pop_ready(self, ready) -> Optional[PartitionTask]:
        """Pop the highest-priority task satisfying ``ready``, skipping
        blocked heads (a round-blocked key, or a drained owner's
        partition under owner-scoped credits, must not head-of-line-block
        a sibling whose window or credits are open). Skipped items keep
        their heap position."""
        skipped = []
        got = None
        while self._heap:
            item = heapq.heappop(self._heap)
            if ready(item[2]):
                got = item[2]
                break
            skipped.append(item)
        for it in skipped:
            heapq.heappush(self._heap, it)
        return got

    def peek(self) -> Optional[PartitionTask]:
        if not self._heap:
            return None
        return self._heap[0][2]

    def __len__(self) -> int:
        return len(self._heap)


class PipelineScheduler:
    """Drives PartitionTasks through stages in priority order under credits.

    One instance per process (the reference had one set of queues+loops per
    GPU process).
    """

    def __init__(
        self,
        stages: Sequence[Stage],
        credit: int = 4,
        credit_scope: str = "global",
        rounds_window: Optional[int] = None,
    ) -> None:
        """``credit_scope="owner"`` gives each partition owner (the pod
        controller whose NIC carries it, ``Partition.owner``) its own
        pool of ``credit``: one owner's slow or faulted wire backs off
        only its own partitions instead of starving its siblings' NICs.
        "global" (the default) is one shared pool.

        ``rounds_window=K`` arms a per-KEY run-ahead bound on top of the
        credit gate: a task whose ``round`` is more than K rounds ahead of
        its key's oldest still-in-flight round is held in its queue. A
        round-blocked head is SKIPPED (other keys keep flowing); None =
        ungated."""
        if credit_scope not in ("global", "owner"):
            raise ValueError(f"unknown credit_scope {credit_scope!r}")
        self.stages = list(stages)
        register_stage_order([s.name for s in self.stages])
        # metrics handles resolved ONCE (the per-op cost is the metric's
        # own lock + arithmetic, never a name lookup)
        _reg = get_registry()
        sid = next(_SCHED_SEQ)
        self._m_run = [_reg.histogram(f"scheduler.stage.{s.name}.run_us")
                       for s in self.stages]
        self._m_dwell = [_reg.histogram(f"scheduler.stage.{s.name}.dwell_us")
                         for s in self.stages]
        self._m_credit_in_use = _reg.gauge(
            f"scheduler.s{sid}.credits_in_use")
        self._m_rounds_inflight = _reg.gauge(
            f"scheduler.s{sid}.rounds_inflight")
        self._m_tasks_done = _reg.counter("scheduler.tasks_done")
        self._m_tasks_failed = _reg.counter("scheduler.tasks_failed")
        self._m_stage_retries = _reg.counter("scheduler.stage_retries")
        self._credits_in_use = 0
        self._queues = [_StageQueue() for _ in self.stages]
        self._credit_total = max(1, credit)
        self._credit_scope = credit_scope
        self._credits = self._credit_total
        # owner scope: pool id -> available credits, created on first use
        self._owner_credits: Dict[int, int] = {}
        # per-key in-flight ROUNDS (rounds_window): key -> set of rounds
        # with at least one task between enqueue and finish
        self._rounds_window = (None if rounds_window is None
                               else max(0, int(rounds_window)))
        self._key_rounds: Dict[int, set] = {}
        self._lock = threading.Lock()
        self._pools: List[ThreadPoolExecutor] = [
            ThreadPoolExecutor(
                max_workers=s.pool_size, thread_name_prefix=f"bps-{s.name}"
            )
            for s in self.stages
        ]
        self._busy = [0] * len(self.stages)
        self._shutdown = False
        self._inflight = 0
        self._idle = threading.Condition(self._lock)

    # -- public API ---------------------------------------------------------
    def enqueue(self, tasks: Sequence[PartitionTask]) -> None:
        if self._shutdown:
            raise RuntimeError("PipelineScheduler is shut down")
        with self._lock:
            for t in tasks:
                self._inflight += 1
                if self._rounds_window is not None and t.round is not None:
                    self._key_rounds.setdefault(
                        t.partition.key, set()).add(t.round)
                self._queues[t.stage_idx].push(t)
            self._update_rounds_gauge_locked()
        self._pump()

    def set_credit(self, credit: int) -> None:
        """Adjust total credit (auto-tuner hook); takes effect as credits recycle."""
        with self._lock:
            delta = max(1, credit) - self._credit_total
            self._credit_total = max(1, credit)
            self._credits += delta
            for pool in self._owner_credits:
                self._owner_credits[pool] += delta
        self._pump()

    # -- round-window accounting (call with self._lock held) ----------------
    def _round_ready_locked(self, task: PartitionTask) -> bool:
        """True when ``task`` is within the per-key run-ahead window: its
        round is at most ``rounds_window`` ahead of the oldest round its
        key still has in flight. Unblocks monotonically — rounds only
        LEAVE the in-flight set at finish, so a task that passes here
        keeps passing at every later stage."""
        if self._rounds_window is None or task.round is None:
            return True
        rounds = self._key_rounds.get(task.partition.key)
        if not rounds:
            return True
        return task.round - min(rounds) <= self._rounds_window

    def _retire_round_locked(self, task: PartitionTask) -> None:
        if self._rounds_window is None or task.round is None:
            return
        rounds = self._key_rounds.get(task.partition.key)
        if rounds is not None:
            rounds.discard(task.round)
            if not rounds:
                del self._key_rounds[task.partition.key]
        self._update_rounds_gauge_locked()

    def _update_rounds_gauge_locked(self) -> None:
        if self._rounds_window is None:
            return
        self._m_rounds_inflight.set(
            max((len(r) for r in self._key_rounds.values()), default=0))

    # -- credit accounting (call with self._lock held) ----------------------
    def _credit_available(self, task: PartitionTask) -> bool:
        if self._credit_scope == "global":
            return self._credits > 0
        return self._owner_credits.get(
            task.partition.owner, self._credit_total) > 0

    def _acquire_credit_locked(self, task: PartitionTask) -> None:
        task.holds_credit = True
        self._credits_in_use += 1
        self._m_credit_in_use.set(self._credits_in_use)
        if self._credit_scope == "global":
            task.credit_pool = 0
            self._credits -= 1
            return
        pool = task.partition.owner
        task.credit_pool = pool
        self._owner_credits[pool] = self._owner_credits.get(
            pool, self._credit_total) - 1

    def _release_credit_locked(self, task: PartitionTask) -> None:
        if not task.holds_credit:
            return
        task.holds_credit = False
        self._credits_in_use -= 1
        self._m_credit_in_use.set(self._credits_in_use)
        if self._credit_scope == "global":
            self._credits = min(self._credits + 1, self._credit_total)
            return
        pool = task.credit_pool
        self._owner_credits[pool] = min(
            self._owner_credits.get(pool, self._credit_total) + 1,
            self._credit_total)

    def credit_pools(self) -> Dict[int, int]:
        """Snapshot of available credits per pool (leak assertions): the
        global pool under key 0; owner scope, every pool touched."""
        with self._lock:
            if self._credit_scope == "global":
                return {0: self._credits}
            return dict(self._owner_credits)

    def drain(self, timeout: Optional[float] = None) -> None:
        with self._idle:
            if not self._idle.wait_for(
                    lambda: self._inflight == 0 or self._shutdown, timeout):
                raise TimeoutError("scheduler drain timed out")
            if self._shutdown:
                # shutdown() failed everything that was in flight; a drain
                # racing it must report that, not pretend a clean flush
                raise RuntimeError("PipelineScheduler was shut down while "
                                   "draining")

    def shutdown(self) -> None:
        """Stop the pipeline. Every queued task's handle is FAILED (so
        ``Handle.wait()`` raises instead of blocking forever on a
        partition that will never run), in-flight tasks fail on stage
        exit, and pending retry timers fail their tasks when they fire."""
        stranded: List[PartitionTask] = []
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            for q in self._queues:
                while True:
                    t = q.pop()
                    if t is None:
                        break
                    stranded.append(t)
                    self._release_credit_locked(t)
            self._inflight -= len(stranded)
            self._key_rounds.clear()  # window state dies with the pipeline
        err = RuntimeError("PipelineScheduler is shut down")
        for t in stranded:
            t.handle._partition_failed(err, t.partition.part_idx)
        with self._idle:
            self._idle.notify_all()
        for p in self._pools:
            p.shutdown(wait=False)

    # -- internals ----------------------------------------------------------
    def _pump(self) -> None:
        """Issue as many ready tasks as credits/pools allow, priority first."""
        while True:
            issued = None
            with self._lock:
                if self._shutdown:
                    return
                for si, stage in enumerate(self.stages):
                    q = self._queues[si]
                    if not len(q):
                        continue
                    if self._busy[si] >= self.stages[si].pool_size:
                        continue
                    # A task acquires at most one credit for its whole
                    # lifetime (reference: credit held from PUSH until the
                    # partition completes); one already holding a credit
                    # passes later credited stages freely. With the
                    # rounds window armed, a round-blocked head is
                    # SKIPPED (its unblockers are earlier rounds in
                    # LATER stages, never behind it in this queue).
                    if self._rounds_window is not None or (
                            stage.credited
                            and self._credit_scope == "owner"):
                        task = q.pop_ready(
                            lambda t: self._round_ready_locked(t)
                            and (not stage.credited or t.holds_credit
                                 or self._credit_available(t)))
                        if task is None:
                            continue
                        if stage.credited and not task.holds_credit:
                            self._acquire_credit_locked(task)
                    else:
                        head = q.peek()
                        needs_credit = (stage.credited
                                        and not head.holds_credit)
                        if needs_credit and not self._credit_available(head):
                            # a stage-retried head gave its credit back;
                            # the tasks behind it that hold one must pass
                            # it, or the credits it waits for never return
                            task = q.pop_ready(lambda t: t.holds_credit)
                            if task is None:
                                continue
                        else:
                            task = q.pop()
                            if needs_credit:
                                self._acquire_credit_locked(task)
                    self._busy[si] += 1
                    issued = (si, task)
                    break
            if issued is None:
                return
            si, task = issued
            try:
                self._pools[si].submit(self._run_stage, si, task)
            except RuntimeError as e:
                # shutdown() ran between our pop and this submit: the pool
                # rejects new work. The task is in no queue, so shutdown's
                # strand sweep missed it — fail its handle here or wait()
                # would hang.
                with self._lock:
                    self._busy[si] -= 1
                self._finish(task, error=RuntimeError(
                    f"PipelineScheduler is shut down ({e})"))
                return

    def _run_stage(self, si: int, task: PartitionTask) -> None:
        stage = self.stages[si]
        t_issue = time.perf_counter()
        if task.queued_at:
            self._m_dwell[si].observe((t_issue - task.queued_at) * 1e6)
        try:
            result = stage.fn(task)
            task.payload = result
            failed = None
        except BaseException as e:  # noqa: BLE001 - propagate via handle
            failed = e
        self._m_run[si].observe((time.perf_counter() - t_issue) * 1e6)
        retrying = (
            failed is not None
            and stage.retryable
            and not self._shutdown
            and task.stage_attempts + 1 < stage.max_attempts
            and getattr(failed, "retryable", True)
        )
        if failed is not None:
            if retrying:
                log.warning(
                    "stage %s failed for %s.%d (attempt %d/%d, will "
                    "retry): %s", stage.name, task.name,
                    task.partition.part_idx, task.stage_attempts + 1,
                    stage.max_attempts, failed)
            else:
                log.error("stage %s failed for %s.%d: %s",
                          stage.name, task.name, task.partition.part_idx,
                          failed)
        with self._lock:
            self._busy[si] -= 1
            if (failed is None and stage.releases_credit) or retrying:
                # wire-scoped credit: frees on stage exit so the next
                # partition's push can start while this one drains the
                # rest of the pipeline (_finish's release is then a
                # no-op); a task about to back off must not keep a credit
                # out of the pool either — the retry re-acquires it
                # through the normal credited-stage gate
                self._release_credit_locked(task)
        if retrying:
            task.stage_attempts += 1
            self._m_stage_retries.inc()
            delay = stage.retry_backoff_s * (2 ** (task.stage_attempts - 1))
            timer = threading.Timer(delay, self._requeue_retry, (si, task))
            timer.daemon = True
            timer.start()
            self._pump()  # the freed credit may unblock a sibling now
            return
        if failed is not None:
            self._finish(task, error=failed)
        elif si + 1 < len(self.stages):
            task.stage_idx = si + 1
            task.stage_attempts = 0  # fresh budget at the next stage
            with self._lock:
                stranded = self._shutdown
                if not stranded:
                    self._queues[si + 1].push(task)
            if stranded:
                # shutdown() already drained the queues; a task advancing
                # past it must fail its handle, not sit in a dead queue
                self._finish(task, error=RuntimeError(
                    "PipelineScheduler is shut down"))
            else:
                self._pump()
        else:
            self._finish(task)

    def _requeue_retry(self, si: int, task: PartitionTask) -> None:
        """Backoff timer fired: put the task back on its own stage's
        priority queue (its sort key is unchanged, so a high-priority
        retry still jumps the line)."""
        with self._lock:
            if not self._shutdown:
                self._queues[si].push(task)
                task = None  # enqueued; not stranded
        if task is not None:  # raced shutdown(): fail, don't strand
            task.handle._partition_failed(
                RuntimeError("PipelineScheduler is shut down"),
                task.partition.part_idx)
            with self._idle:
                self._inflight -= 1
                self._idle.notify_all()
            return
        self._pump()

    def _finish(self, task: PartitionTask, error: Optional[BaseException] = None) -> None:
        """Reference analog: FinishOrProceed's terminal arm."""
        with self._lock:
            self._release_credit_locked(task)
            self._retire_round_locked(task)
            self._inflight -= 1
        if error is not None:
            self._m_tasks_failed.inc()
            task.handle._partition_failed(error, task.partition.part_idx)
        else:
            self._m_tasks_done.inc()
            task.handle._partition_done(task.partition.part_idx, task.payload)
        with self._idle:
            if self._inflight == 0:
                self._idle.notify_all()
        self._pump()
