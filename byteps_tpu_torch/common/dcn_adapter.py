"""Shared worker-side core for host-framework adapters (the port's
counterpart of ``byteps_tpu/common/dcn_adapter.py``).

Reference analog: the common machinery ``byteps/torch/ops.cc`` calls into
(``EnqueueTensor`` + queue lists, ``operations.cc``): tensor
declaration/partitioning, the credit-scheduled PUSH/PULL pipeline against
the DCN summation servers, and handle assembly.

A flat CPU buffer (numpy, or a CPU tensor) runs the reference's four
stages, ``DCN_STAGE_ORDER``, unchanged. A CUDA tensor runs
``CUDA_DCN_STAGE_ORDER``: ``push_pull_async`` records an event on the
caller's current stream and issues one ``non_blocking`` copy of the
tensor into a pinned host buffer (kept per tensor name) on a copy stream
that waits on that event; ``COPYD2H``, on a pool thread, waits for that
copy; the pulled sums are decoded into a second pinned buffer of the
name, and ``COPYH2D`` copies each partition back into the tensor on the
copy stream and waits for it, so a finished handle holds its result on
the card and neither pinned buffer is still in use.

A core holds one PSWorker a pod controller (``BYTEPS_POD_CONTROLLERS``
under ``BYTEPS_HYBRID_SHARDED``, else one), all pushing under the pod's
worker id; each partition crosses the wire through its owner's
(``OwnerTable``), and credits are scoped per owner. A controller whose
NIC dies fails over: its rounds move to the survivors and its partitions
remap. Each PSWorker fails servers over (docs/robustness.md); with no
live server left, the last controller degrades a partition to this
worker's own contribution under ``BYTEPS_DEGRADED_OK`` (the default) and
fails its handle otherwise.

Elastic membership: each PULL records the round it was served from (the
codec seed of its decode) and the live count of the epoch its round
closed under (``handle.part_live``, the divisor of an average); a push
refused as evicted drops its pinned round, so that the stage retry mints
afresh after the in-line rejoin; :meth:`DcnCore.join` admits the pod
into a running job. Under ``BYTEPS_STALENESS=K`` the schedulers keep up
to K+1 rounds of a key in flight (``rounds_window``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from byteps_tpu_torch.common.config import check_ported, get_config
from byteps_tpu_torch.common.flight_recorder import get_flight_recorder
from byteps_tpu_torch.common.faults import (
    FaultPlan,
    ServerDownError,
    parse_fault_spec,
)
from byteps_tpu_torch.common.logging import bps_check, get_logger
from byteps_tpu_torch.common.metrics import get_registry
from byteps_tpu_torch.common.partition import OwnerTable, TensorRegistry
from byteps_tpu_torch.common.scheduler import (
    Handle,
    PartitionTask,
    PipelineScheduler,
    Stage,
)
from byteps_tpu_torch.common.stage_orders import (
    CUDA_DCN_STAGE_ORDER,
    DCN_STAGE_ORDER,
)
from byteps_tpu_torch.compression.wire import (
    Fp16Wire,
    WireCodec,
    WirePlan,
    pull_seed,
    wire_seed,
)
from byteps_tpu_torch.server import (
    FailedOverError,
    NoLiveServersError,
    PSWorker,
    WorkerEvictedError,
    hand_off_owner,
    retire_nic,
)

log = get_logger("dcn_adapter")


def owner_wire_death(e: BaseException) -> bool:
    """Whether a wire error that escaped the PSWorker's retries blames the
    owner's own NIC (a pod of several controllers): a connection-class
    error means every attempt through that owner's connections failed,
    so its partitions remap to the surviving controllers. Server-side
    conditions are not owner deaths: a failover in progress, no live
    server, a server-down window past the retry budget (it names the
    server; remapping would let one outage kill every controller in
    turn), a receive timeout (a slow server as likely as a dead NIC,
    which shows as a refused reconnect next) and a CRC-detected
    corruption. Those get the stage retry; failover is irreversible."""
    if isinstance(e, (NoLiveServersError, FailedOverError,
                      ServerDownError)):
        return False
    return isinstance(e, ConnectionError)


def remap_dead_owner(task, owner: int, owners, fail_owner, owner_of,
                     cause: BaseException, verb: str) -> None:
    """The owner-failover policy of DcnCore and eager's hybrid pipeline:
    fail ``owner`` over (or find that a sibling task already did, which
    ``fail_owner`` reports as False, as it does for the last controller)
    and raise a stage-retryable error, so that the re-run resolves a
    survivor. Returns without raising only when no survivor exists (the
    last controller): the caller's degraded or terminal path decides."""
    failed = fail_owner(owner, cause)
    if failed or owner not in owners.live():
        err = RuntimeError(
            f"owner {owner} {verb} for {task.name}."
            f"{task.partition.part_idx}; remapped: retrying via owner "
            f"{owner_of(task.partition.key)}")
        err.retryable = True
        raise err from cause


def stall_diag(workers, owners, schedulers) -> Dict[str, Any]:
    """A ``Handle.diag`` payload, shared by DcnCore and eager's hybrid
    pipeline so their stall reports never drift: per-NIC robustness and
    health counters, bytes on the wire, live servers and owners, and the
    schedulers' credit pools and busy stages. ``workers`` is the process's
    PSWorkers (none on a rank that is no controller), ``owners`` its
    ``OwnerTable`` (None where there is none), ``schedulers`` its
    pipelines (None where one is not built)."""
    scheds = [s for s in schedulers if s is not None]
    return {
        "workers": {f"nic{r}": w.get_counters()
                    for r, w in enumerate(workers)},
        "wire_bytes": {f"nic{r}": {"pushed": w.bytes_pushed,
                                   "pulled": w.bytes_pulled}
                       for r, w in enumerate(workers)},
        "live_servers": {f"nic{r}": sorted(w.live_servers())
                         for r, w in enumerate(workers)},
        "live_owners": sorted(owners.live()) if owners is not None else None,
        "credit_pools": [s.credit_pools() for s in scheds],
        "stage_busy": [{st.name: b for st, b in zip(s.stages, s._busy)}
                       for s in scheds],
    }


class DegradedLocal:
    """Marker payload riding PULL when the whole DCN tier is dead: carries
    the encoded LOCAL contribution through the pipeline, so DECOMPRESS
    yields this worker's own sum instead of the cross-worker one —
    graceful degradation (BYTEPS_DEGRADED_OK) rather than a failed handle.
    Shared with eager's hybrid pipeline, where the local contribution is
    the pod's sum."""

    __slots__ = ("payload",)

    def __init__(self, payload):
        self.payload = payload


def degraded_fallback(worker, cfg, task, adapter_log, what: str):
    """The no-live-servers gate of the PUSH stages (DcnCore and eager's
    hybrid): fails fast when BYTEPS_DEGRADED_OK is off, else counts the
    fallback, warns once, and wraps the task's payload (the encoded local
    contribution) in :class:`DegradedLocal`.

    Degradation is recorded PER PARTITION: ``handle.degraded_parts`` maps
    part_idx -> (offset, length). A handle can be mixed — earlier
    partitions aggregated globally before the last server died — so
    averaging divides slice by slice: global slices by the global size,
    degraded ones by the participants the fallback could reach."""
    p = task.partition
    if not cfg.degraded_ok:
        err = NoLiveServersError(
            f"push {task.name}.{p.part_idx}: no live summation servers "
            "(BYTEPS_DEGRADED_OK=0)")
        # fail-fast: a stage retry cannot help when degrading is forbidden
        err.retryable = False
        raise err
    worker._count("ici_fallbacks")
    if worker.counters["ici_fallbacks"] == 1:
        adapter_log.warning(
            "no live summation servers: degrading push_pull to %s "
            "(BYTEPS_DEGRADED_OK)", what)
    task.degraded = True  # DECOMPRESS decodes the PUSH-side encoding
    with task.handle._lock:
        parts = getattr(task.handle, "degraded_parts", None)
        if parts is None:
            parts = {}
            task.handle.degraded_parts = parts
        parts[p.part_idx] = (p.offset, p.length)
    return DegradedLocal(task.payload)


def live_average(x: np.ndarray, d: int, live: Optional[int]) -> np.ndarray:
    """A partition's f32 sum ``x`` as an average, in the reference torch
    adapter's arithmetic, bit for bit: ``x / d`` with ``d`` the adopted
    live count, then ``* (d / live)`` when the partition's round closed
    under another membership (``live``; None: the same). That is not
    bitwise ``x / live``, and the parity tests hold it to the reference's
    bytes."""
    out = x / d
    if live is not None and live != d:
        out *= d / np.float32(live)
    return out


def wire_codec_for(compression: Optional[str]) -> Optional[WireCodec]:
    """Map a host adapter's ``Compression`` choice onto a DCN wire codec
    (reference: byteps/torch/compression.py — fp16 halves actual wire
    bytes, it is not a round-trip simulation)."""
    if compression in (None, "none", ""):
        return None
    if compression == "fp16":
        return Fp16Wire()
    raise ValueError(f"unknown compression {compression!r}; "
                     "host adapters support 'none' or 'fp16'")


class HostStaging:
    """The host side of a CUDA tensor's trip over the wire: one copy
    stream per device, and per tensor name a pair of pinned f32 host
    buffers (push, pull), kept for the process's later rounds of the
    name. Shared by :class:`DcnCore` and the hybrid pipeline of
    ``byteps_tpu_torch.eager``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._streams: Dict[int, torch.cuda.Stream] = {}
        self._pinned: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def copy_stream(self, device: torch.device) -> torch.cuda.Stream:
        with self._lock:
            s = self._streams.get(device.index)
            if s is None:
                s = self._streams[device.index] = torch.cuda.Stream(device)
            return s

    def pinned_buffers(self, name: str, n: int):
        with self._lock:
            bufs = self._pinned.get(name)
            if bufs is None:
                bufs = self._pinned[name] = tuple(
                    torch.empty(n, dtype=torch.float32, pin_memory=True)
                    for _ in range(2))
            return bufs


class DcnCore:
    """One per process; drives flat fp32 buffers through the DCN pipeline.

    Stages mirror the reference queue list around the wire
    (``core_loops.cc`` COMPRESS → PUSH → PULL → DECOMPRESS): codec work
    runs on its own pool so chunk i+1 compresses WHILE chunk i is on the
    wire. The credit is acquired at COMPRESS and released when the chunk
    leaves PUSH (``releases_credit`` wire scope): at most ``credit``
    encoded payloads exist at once, overlap survives whenever credit ≥ 2
    (default 4), and slow pulls never starve later pushes. CUDA tensors
    take the same stages between ``COPYD2H`` and ``COPYH2D`` on a
    pipeline of their own, built at the first CUDA call.
    """

    def __init__(self, servers=None, worker_id=None,
                 pod_controllers: Optional[int] = None,
                 fault_specs: Optional[Sequence[Optional[str]]] = None,
                 health_interval_ms: Optional[int] = None) -> None:
        """``pod_controllers`` > 1 models the pod as that many
        controllers, each its own PSWorker (connections, pacer, fault
        plan, health monitor), all under the pod's worker id; each
        partition is compressed, pushed and pulled by its rendezvous-
        hashed owner alone, so the wire bytes divide over the NICs.
        Default: ``BYTEPS_POD_CONTROLLERS`` under
        ``BYTEPS_HYBRID_SHARDED``, else 1. ``fault_specs`` arms one fault
        plan an owner (None: none), ``health_interval_ms`` each worker's
        monitor (None: ``BYTEPS_HEALTH_INTERVAL_MS``)."""
        cfg = get_config()
        check_ported(cfg)
        self.cfg = cfg
        if pod_controllers is None:
            pod_controllers = (max(1, cfg.pod_controllers)
                               if cfg.hybrid_sharded else 1)
        plans: List[Optional[FaultPlan]] = [None] * pod_controllers
        if fault_specs is not None:
            bps_check(len(fault_specs) == pod_controllers,
                      f"fault_specs needs one entry per controller (got "
                      f"{len(fault_specs)} for {pod_controllers})")
            plans = [FaultPlan(parse_fault_spec(spec), seed=cfg.fault_seed,
                               worker_id=o) if spec else None
                     for o, spec in enumerate(fault_specs)]
        # every controller pushes under the pod's worker id: the server
        # sees one contribution a pod, and its (worker, key, round) replay
        # dedupe survives an owner remap, since the survivor adopts the
        # dead owner's round counters (PSWorker.adopt_rounds)
        self.workers: List[PSWorker] = [
            PSWorker(servers=servers, worker_id=worker_id,
                     fault_plan=plans[o],
                     health_interval_ms=health_interval_ms)
            for o in range(pod_controllers)]
        self.worker = self.workers[0]        # NIC 0: barrier and goodbye
        self.owners = OwnerTable(pod_controllers, salt=cfg.owner_salt)
        self._owner_lock = threading.Lock()
        self.owner_failovers = 0
        self.registry = TensorRegistry()
        # PUSH/PULL are stage-retryable: the second line of defense above
        # PSWorker's wire retries (a pinned round is re-sent, see
        # _push_stage); one more attempt a controller, since a total
        # outage spends one failing each owner over before the last
        # degrades
        self._wire_stages = [
            Stage("COMPRESS", self._compress_stage, credited=True,
                  pool_size=2),
            Stage("PUSH", self._push_stage, credited=True, pool_size=4,
                  releases_credit=True, retryable=True,
                  max_attempts=2 + pod_controllers),
            Stage("PULL", self._pull_stage, pool_size=4, retryable=True,
                  max_attempts=2 + pod_controllers),
            Stage("DECOMPRESS", self._decompress_stage, pool_size=2),
        ]
        bps_check(
            tuple(s.name for s in self._wire_stages) == DCN_STAGE_ORDER,
            "DcnCore stage list drifted from DCN_STAGE_ORDER")
        # several controllers scope credits per owner: one faulted NIC
        # backing off does not starve its siblings' wires
        self._credit_scope = "owner" if pod_controllers > 1 else "global"
        # bounded staleness: a caller that pipelines may keep K+1 rounds of
        # a key in flight (round r+K's PUSH no longer waits for round r's
        # PULL); the server serves within K, the window bounds the run-ahead
        self._rounds_window = cfg.staleness if cfg.staleness > 0 else None
        self.scheduler = PipelineScheduler(
            stages=self._wire_stages, credit=cfg.scheduling_credit,
            credit_scope=self._credit_scope,
            rounds_window=self._rounds_window)
        self._cuda_scheduler: Optional[PipelineScheduler] = None
        self._staging = HostStaging()
        # the keys each owner has initialised on the servers: an owner
        # that inherits a key re-runs the idempotent init first
        self._inited_keys: Dict[int, Set[int]] = {
            o: set() for o in range(pod_controllers)}
        self._key_lock = threading.Lock()
        self._versions: Dict[str, int] = {}
        self.bytes_d2h = 0
        self.bytes_h2d = 0
        _reg = get_registry()
        self._m_d2h = _reg.counter("dcn.d2h_bytes")
        self._m_h2d = _reg.counter("dcn.h2d_bytes")
        # a worker id beyond DMLC_NUM_WORKER is no member the start barrier
        # counts: it enters the running job through join()
        if self.worker._worker_id < cfg.num_worker:
            self.worker.barrier()

    # -- the CUDA pipeline ---------------------------------------------------
    def _cuda_pipeline(self) -> PipelineScheduler:
        with self._key_lock:
            if self._cuda_scheduler is None:
                stages = ([Stage("COPYD2H", self._d2h_stage, pool_size=2)]
                          + [dataclasses.replace(s)
                             for s in self._wire_stages]
                          + [Stage("COPYH2D", self._h2d_stage, pool_size=2)])
                bps_check(
                    tuple(s.name for s in stages) == CUDA_DCN_STAGE_ORDER,
                    "DcnCore CUDA stage list drifted from "
                    "CUDA_DCN_STAGE_ORDER")
                self._cuda_scheduler = PipelineScheduler(
                    stages=stages, credit=self.cfg.scheduling_credit,
                    credit_scope=self._credit_scope,
                    rounds_window=self._rounds_window)
            return self._cuda_scheduler

    # -- ownership ------------------------------------------------------------
    def _owner_of(self, key: int) -> int:
        return self.owners.owner(key)

    def fail_owner(self, rank: int,
                   cause: Optional[BaseException] = None) -> bool:
        """Mark controller ``rank`` dead and remap its partitions to the
        survivors (fence, export, adopt, shrink: ``hand_off_owner``).
        This core keeps no per-owner codec state to reset. False if
        ``rank`` is already dead or the last controller (then the
        degraded or terminal path decides)."""
        with self._owner_lock:
            if hand_off_owner(self.workers, self.owners, rank) is None:
                return False
            self.owner_failovers += 1
        if rank != 0:
            # nothing routes through the dead NIC again; NIC 0 stays open,
            # fenced, for the pod's one goodbye round
            retire_nic(self.workers[rank])
        log.warning("pod controller %d gave up its wire (%s); its "
                    "partitions remap to owners %s", rank,
                    cause if cause is not None else "requested",
                    sorted(self.owners.live()))
        return True

    def _owner_giveup(self, task: PartitionTask, owner: int,
                      e: BaseException):
        """A wire error through ``owner``'s NIC past its retries: fail the
        owner over and raise stage-retryably, so that the re-run lands on
        a survivor; anything else, or the last controller, re-raises."""
        if len(self.workers) > 1 and owner_wire_death(e):
            remap_dead_owner(task, owner, self.owners, self.fail_owner,
                             self._owner_of, e, "wire dead")
        raise e

    def _d2h_stage(self, task: PartitionTask):
        task.context["d2h"].synchronize()
        return None

    def _h2d_stage(self, task: PartitionTask):
        p = task.partition
        ctx = task.context
        stream = ctx["stream"]
        with torch.cuda.stream(stream):
            ctx["device"][p.offset:p.offset + p.length].copy_(
                ctx["pull_t"][p.offset:p.offset + p.length],
                non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        with self._key_lock:
            self.bytes_h2d += p.length * 4
        self._m_h2d.inc(p.length * 4)
        return None

    # -- the wire stages ------------------------------------------------------
    def _compress_stage(self, task: PartitionTask):
        """Wire encode on the codec pool (reference COMPRESS stage) —
        decoupled from PUSH so the encode of chunk i+1 overlaps the wire
        time of chunk i."""
        p = task.partition
        flat: np.ndarray = task.context["flat"]
        # fp32 coercion here, not at push: the registry declared float32
        # and the store was sized at length*4
        chunk = np.ascontiguousarray(
            flat[p.offset:p.offset + p.length], np.float32)
        plan: Optional[WirePlan] = task.context["plans"][p.part_idx]
        if plan is None:
            return chunk.view(np.uint8).ravel()
        return plan.codec.encode(
            chunk,
            wire_seed(task.name, task.context["version"], p.part_idx),
        )

    def _push_stage(self, task: PartitionTask):
        p = task.partition
        owner = self._owner_of(p.key)
        worker = self.workers[owner]
        if not worker.has_live_servers():
            # this NIC sees no live server; each worker's monitor pings
            # through its own connections, so with siblings alive that is
            # the owner's link dying: fail the owner over first (degrading
            # here would make this partition pod-local while other pods
            # sum globally). A total outage walks the owners down to the
            # last controller, which degrades.
            if len(self.workers) > 1:
                remap_dead_owner(
                    task, owner, self.owners, self.fail_owner,
                    self._owner_of,
                    NoLiveServersError(
                        f"owner {owner} sees no live servers"),
                    "lost all servers")
            # total DCN outage: degrade to the local contribution instead
            # of failing the handle (docs/robustness.md)
            return degraded_fallback(worker, self.cfg, task, log,
                                     "LOCAL sums")
        plan: Optional[WirePlan] = task.context["plans"][p.part_idx]
        store_bytes = (
            plan.codec.store_elems(p.length) * 4 if plan is not None
            else p.length * 4
        )
        with self._key_lock:
            needs_init = p.key not in self._inited_keys[owner]
        try:
            if needs_init:
                # server-side init is idempotent and never resets an
                # existing store, so only this owner's init must precede
                # its own push (serial on its connection); marked only
                # after success, so a stage retry re-runs a failed init
                worker.init_key(p.key, store_bytes)
                with self._key_lock:
                    self._inited_keys[owner].add(p.key)
            codec_id = plan.codec.codec_id if plan is not None else 0
            # pin the round BEFORE the wire attempt: a stage retry, on
            # this owner or a survivor after a failover, must re-send the
            # SAME round, whether the first try was applied (ack lost: the
            # server dedupe drops the re-send) or never arrived
            task.push_version = worker.mint_version(
                p.key, getattr(task, "push_version", None))
            return worker.push_bytes(p.key, task.payload, codec_id,
                                     version=task.push_version)
        except BaseException as e:  # noqa: BLE001 - owner-death classify
            if isinstance(e, WorkerEvictedError):
                # the rejoin adopted the server's watermarks: a pin at or
                # below them would be dropped as a replay and the key
                # stall for good, so the stage retry mints afresh
                task.push_version = None
            self._owner_giveup(task, owner, e)

    def _pull_stage(self, task: PartitionTask):
        if isinstance(task.payload, DegradedLocal):
            return task.payload.payload  # DECOMPRESS decodes the local sum
        p = task.partition
        plan: Optional[WirePlan] = task.context["plans"][p.part_idx]
        capacity = (plan.pull_capacity(p.length) if plan is not None
                    else p.length * 4)
        codec_id = plan.pull_codec_id if plan is not None else 0
        owner = self._owner_of(p.key)
        worker = self.workers[owner]
        try:
            out = worker.pull_bytes(p.key, capacity, task.payload, codec_id)
        except BaseException as e:  # noqa: BLE001 - owner-death classify
            self._owner_giveup(task, owner, e)
        # the served round (up to K behind the requested one under bounded
        # staleness) keys DECOMPRESS's seed; the live count of the epoch
        # the round closed under divides it: a handle can be mixed across
        # a membership change, as across a degraded partition
        task.served_round = worker.last_pull_round()
        task.round_live = worker.last_round_live()
        with task.handle._lock:
            parts = getattr(task.handle, "part_live", None)
            if parts is None:
                parts = task.handle.part_live = {}
            parts[p.part_idx] = (p.offset, p.length, task.round_live)
        return out

    def _decompress_stage(self, task: PartitionTask):
        """Wire decode of the pulled round result (reference DECOMPRESS),
        off the wire pool so decodes overlap later chunks' pulls, with
        the seed of the round it was served from; averaged (``average``)
        in f32 on the host by :func:`live_average` over the live count
        adopted when the partition is decoded, and, for a CUDA tensor,
        written into the name's pinned pull buffer. A degraded partition
        decodes its push-side encoding (the pull format never existed for
        its round) and is not divided: it is this worker's contribution
        alone."""
        p = task.partition
        ctx = task.context
        plan: Optional[WirePlan] = ctx["plans"][p.part_idx]
        buf = np.ascontiguousarray(task.payload)
        degraded = getattr(task, "degraded", False)
        if plan is None:
            out = buf.view(np.float32)
        else:
            seed = pull_seed(task.name, ctx["version"], p.part_idx,
                             served_round=getattr(task, "served_round", None),
                             staleness=self.cfg.staleness, degraded=degraded)
            out = (plan.codec.decode(buf, p.length, seed) if degraded
                   else plan.decode_pull(buf, p.length, seed))
        if ctx["average"] and not degraded:
            out = live_average(out, self.live_size(),
                               getattr(task, "round_live", None))
        dst = ctx.get("pull")
        if dst is None:
            return out
        dst[p.offset:p.offset + p.length] = out
        return None

    # -- elasticity -----------------------------------------------------------
    def join(self) -> int:
        """Mid-stream admission of this pod into a running job: the kJoin
        handshake and the round-watermark adoption on every controller
        NIC (:meth:`PSWorker.join`, all under the pod's worker id), so the
        pod enters at a round boundary. Returns the adopted live pod
        count. A worker id beyond ``DMLC_NUM_WORKER`` builds its core
        without the start barrier, then calls this."""
        for w in self.workers:
            w.join()
        return self.live_size()

    def live_size(self) -> int:
        """Live workers (pods) in the most recently adopted membership
        epoch: what an average divides by in place of
        ``DMLC_NUM_WORKER``. The least over the pod's NICs: they adopt
        the same epochs, and between adoptions the smaller view is the
        one already shrunk."""
        return max(1, min(w.live_pods() for w in self.workers))

    # -- public -------------------------------------------------------------
    def push_pull_async(self, flat: Union[np.ndarray, torch.Tensor],
                        name: str,
                        priority: Optional[int] = None,
                        codec: Optional[WireCodec] = None,
                        two_way: bool = True,
                        average: bool = False) -> Handle:
        """Enqueue a flat fp32 vector; returns a Handle. ``codec``
        compresses the DCN wire per partition (the server decodes,
        fp32-sums, re-encodes); partitions below
        BYTEPS_MIN_COMPRESS_BYTES ride raw fp32, matching the reference's
        BYTEPS_MIN_COMPRESS_BYTES semantics. ``average`` divides each
        partition's sum by the live workers (:func:`live_average`, f32,
        on the host; a degraded partition, which holds this worker's
        contribution alone, is not). A numpy array or CPU tensor gives
        per-partition numpy results (:meth:`assemble` concatenates them);
        a CUDA tensor (f32, contiguous) receives the result in place."""
        cuda = isinstance(flat, torch.Tensor) and flat.is_cuda
        if isinstance(flat, torch.Tensor) and not cuda:
            flat = flat.detach().numpy()
        n = flat.numel() if cuda else flat.size
        ctx = self.registry.declare(name, (n,), np.float32)
        with self._key_lock:
            version = self._versions.get(name, 0)
            self._versions[name] = version + 1
        # the highest round any tensor reached is the training step: the
        # flight recorder's step ring advances here, where the reference
        # advances its tracer
        get_flight_recorder().on_step(version + 1)
        plans = [
            None
            if codec is None or p.length * 4 < self.cfg.min_compress_bytes
            else WirePlan(codec, two_way)
            for p in ctx.partitions
        ]
        handle = Handle(name, len(ctx.partitions))
        handle.diag = self._stall_diag
        shared = {"flat": flat, "plans": plans, "version": version,
                  "average": average}
        scheduler = self.scheduler
        if cuda:
            bps_check(flat.dtype == torch.float32 and flat.is_contiguous(),
                      f"push_pull of '{name}' on the card needs a "
                      "contiguous f32 tensor")
            push_t, pull_t = self._staging.pinned_buffers(name, n)
            stream = self._staging.copy_stream(flat.device)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(flat.device))
            stream.wait_event(ready)
            with torch.cuda.stream(stream):
                push_t.copy_(flat.detach(), non_blocking=True)
                # the copy stream still reads (and later writes) the tensor
                flat.record_stream(stream)
                d2h = torch.cuda.Event()
                d2h.record(stream)
            with self._key_lock:
                self.bytes_d2h += n * 4
            self._m_d2h.inc(n * 4)
            shared.update(flat=push_t.numpy(), d2h=d2h, stream=stream,
                          device=flat, pull_t=pull_t, pull=pull_t.numpy())
            handle.device_out = flat
            scheduler = self._cuda_pipeline()
        tasks = []
        for p in ctx.partitions:
            # the owner label is the placement at enqueue (the credit
            # pool); the stages re-resolve it, so a failover in flight
            # moves the wire all the same
            p = dataclasses.replace(
                p, owner=self._owner_of(p.key),
                **({"priority": priority} if priority is not None else {}))
            tasks.append(PartitionTask(partition=p, name=name, handle=handle,
                                       context=shared, round=version))
        scheduler.enqueue(tasks)
        return handle

    @staticmethod
    def assemble(handle: Handle, timeout: Optional[float] = 120.0
                 ) -> Union[np.ndarray, torch.Tensor]:
        """Wait for ``handle``: the concatenated numpy result of a CPU
        buffer, or the CUDA tensor that holds its result."""
        results = handle.wait(timeout)
        out = getattr(handle, "device_out", None)
        if out is not None:
            return out
        parts = [results[i] for i in sorted(results)]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _stall_diag(self):
        """Handle.diag callback (shared assembly: :func:`stall_diag`)."""
        return stall_diag(self.workers, self.owners,
                          [self.scheduler, self._cuda_scheduler])

    def bytes_moved(self) -> Tuple[int, int]:
        """(bytes pushed, bytes pulled) over the wire, summed over every
        controller NIC."""
        return (sum(w.bytes_pushed for w in self.workers),
                sum(w.bytes_pulled for w in self.workers))

    def bytes_copied(self) -> Tuple[int, int]:
        """(bytes copied device to host, host to device) by the CUDA
        pipeline."""
        with self._key_lock:
            return self.bytes_d2h, self.bytes_h2d

    def shutdown(self) -> None:
        self.scheduler.shutdown()
        if self._cuda_scheduler is not None:
            self._cuda_scheduler.shutdown()
        # one goodbye round a pod, through NIC 0 (servers count one a
        # pod, and every controller shares the pod's worker id); the
        # other NICs retire
        for w in self.workers[1:]:
            retire_nic(w)
        self.worker.shutdown()
