"""byteps_tpu_torch.eager — the eager surface over a pod of ranks (the
port's counterpart of ``byteps_tpu/jax/__init__.py``, its eager
``push_pull`` path and its hybrid two-tier pipeline)::

    import byteps_tpu_torch.eager as bps

    bps.init()                      # after torch.distributed's own init
    avg = bps.push_pull(grad, name="w")
    grads = bps.push_pull_tree(grads)      # a list or a dict of tensors

**The pod.** The reference's pod is one controller process holding N
devices, and ``push_pull`` takes a stacked ``(N, ...)`` array. Here a pod
is the default ``torch.distributed`` group of N rank processes (without
an initialized group, a pod of one), and each rank passes its own tensor,
with no leading axis. ``pod_size()`` is the group's size,
``local_rank()`` / ``local_size()`` the rank and size in it, ``rank()``
the pod's id (``DMLC_WORKER_ID``, shared by the pod's ranks) and
``size()`` = ``pod_size()`` × ``DMLC_NUM_WORKER``. Pod rank 0 is the
controller: the only rank that holds ``PSWorker`` objects and talks to the
summation servers, which count pods, not ranks. Sharded, it holds one
``PSWorker`` a pod controller NIC (``BYTEPS_POD_CONTROLLERS``, all under
the pod's worker id), and each partition crosses the wire through its
owner's, a rendezvous hash over the live controllers
(``BYTEPS_OWNER_SALT``), with credits scoped per owner.

**Two pipelines**, as in the reference (``:164``–``:267``):

* eager ICI, when not distributed: ``PUSHPULL`` → ``SYNC``, both in the
  caller's thread, as the reference's multi-process branch runs them
  (``:1025``): no scheduler. Each partition takes Nesterov momentum,
  then error feedback (state per ``(name, partition)``), then
  ``allreduce_flat`` or ``compressed_allreduce_flat`` with the key
  ``fold_in(tensor key, partition)``; :func:`synchronize` waits for the
  result (a CUDA event on the card).
* hybrid, when ``DMLC_NUM_WORKER`` > 1 or ``BYTEPS_FORCE_DISTRIBUTED``:
  ``REDUCE`` → ``COPYD2H`` → ``COMPRESS`` → ``PUSH`` → ``PULL`` →
  ``DECOMPRESS`` → ``COPYH2D`` (→ ``ALLGATHER`` under
  ``BYTEPS_HYBRID_SHARDED``, the default). REDUCE sums the partition over
  the pod in the input's dtype: a reduce-scatter when sharded, whose
  segments then reach the controller by a gather that moves bits, else an
  all-reduce; under ``BYTEPS_ICI_TIER=ring`` a compressed partition of
  at least ``BYTEPS_MIN_COMPRESS_BYTES`` takes the ring's compressed
  reduce-scatter (or all-reduce) instead, statelessly. The controller
  copies the pod sum to the host in f32 (pinned memory and a copy stream
  for a CUDA tensor, ``common/dcn_adapter.py`` ``HostStaging``), applies
  host momentum and error feedback, encodes the wire (``wire_seed``),
  pushes, pulls, decodes (``pull_seed``) and copies the global sum back to
  its card; unsharded it reaches the other ranks by a broadcast, sharded
  as per-rank zero-padded segments (a scatter) that an all-gather puts
  together on every rank. The average divides on the device by
  ``pod_size()`` × the live count of the epoch the partition's round
  closed under (``DMLC_NUM_WORKER`` while no pod joined or was evicted).
  The other ranks pass the DCN stages through and move no DCN bytes.

**Collective order.** A process group matches its collectives by issue
order, and each rank runs its own scheduler, whose pop order depends on
timing. So every collective of the pod is issued on every rank in one
order that is a function of the program: REDUCE, the sharded gather and
the eager path's collective in the caller's thread at
``push_pull_async``, partition by partition (the reference's
multi-process rule, ``:1025``), and the tail (broadcast, or scatter and
all-gather) on one thread a rank, first in first out by (call,
partition), over a second process group. The hybrid scheduler carries
COPYD2H to ALLGATHER (REDUCE ran before it, and its time goes to
``scheduler.stage.REDUCE.run_us``); COPYH2D hands the controller's sum
to the tail thread and ALLGATHER waits for its result. Calls must come
from one thread a rank, and a name's next hybrid call comes after
:func:`synchronize` of its last (the controller reuses the name's pinned
host buffers; an earlier call is refused). Every tail collective carries
one status element, so a partition that failed on the controller fails
on every rank instead of leaving them waiting, and a partition that
degraded there is averaged as one on every rank. The controller's DCN
stages keep the scheduler's priority order.

**Robustness.** Each of the controller's ``PSWorker`` objects injects faults,
retries, and fails servers over as ``byteps_tpu_torch.server``
describes. A NIC whose wire dies, or that sees no live server while a
sibling lives, fails its owner over: its round counters move to the
survivors, its partitions remap, and their error-feedback and momentum
state restarts from zero. When the last controller has no live server
left, a partition's PUSH degrades to the pod's REDUCE sum under
``BYTEPS_DEGRADED_OK`` (the default; otherwise the partition fails on
every rank): no DCN bytes move, and the average divides by
``pod_size()`` alone.

**Backend.** The pod has run on gloo only, CPU and CUDA tensors alike.
The hybrid pipeline of a pod of several ranks refuses any other backend
(not ported yet): its two groups issue from two threads in an order that
differs from rank to rank, which gloo allows and NCCL does not
promise to.

**Elastic membership.** Under ``BYTEPS_WORKER_LEASE_MS`` a silent pod
is evicted; each partition's round carries the live count it closed
under, which the controller hands the pod in the tail's status element,
so every rank divides by it. :func:`join` admits a pod into a running
job and fires the :func:`on_membership_change` hooks (the place for a
data-shard remap and :func:`linear_scale`). Under ``BYTEPS_STALENESS=K``
a pull may be served a round up to K behind (decoded with that round's
seed) and the scheduler keeps up to K+1 rounds of a key in flight.

Not ported yet, and refused or absent: the auto-tuner
(``BYTEPS_AUTO_TUNE``), tracing spans, the elastic data-shard map and
autoscaler.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import queue
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from byteps_tpu_torch.comm.ici import (
    all_gather_flat,
    allreduce_flat,
    broadcast_flat,
    compressed_allreduce_flat,
    compressed_reduce_scatter_flat,
    reduce_scatter_flat,
    world,
)
from byteps_tpu_torch.common.config import Config, check_ported, get_config
from byteps_tpu_torch.common.dcn_adapter import (
    DegradedLocal,
    HostStaging,
    degraded_fallback,
    owner_wire_death,
    remap_dead_owner,
    stall_diag,
)
from byteps_tpu_torch.common.logging import bps_check, get_logger
from byteps_tpu_torch.common.metrics import get_registry
from byteps_tpu_torch.common.partition import OwnerTable, TensorRegistry
from byteps_tpu_torch.common.scheduler import (
    Handle,
    PartitionTask,
    PipelineScheduler,
    Stage,
    StallError,
    capped_timeout,
)
from byteps_tpu_torch.common.stage_orders import HYBRID_STAGE_ORDER
from byteps_tpu_torch.compression import (
    CompressionSpec,
    fold_in,
    from_params,
    momentum_step,
)
from byteps_tpu_torch.compression.wire import (
    WirePlan,
    make_wire_codec,
    pull_seed,
    wire_seed,
)
from byteps_tpu_torch.server import (
    NoLiveServersError,
    PSWorker,
    WorkerEvictedError,
    hand_off_owner,
    retire_nic,
)

log = get_logger("eager")


class _EagerState:
    def __init__(self) -> None:
        self.initialized = False
        self.cfg: Optional[Config] = None
        self.registry: Optional[TensorRegistry] = None
        self.scheduler: Optional[PipelineScheduler] = None
        self.spec: Optional[CompressionSpec] = None
        self.seed = 0
        self.versions: Dict[str, int] = {}
        # per-(name, part_idx) EF residual / momentum buffers: torch
        # tensors on the eager path, f32 numpy on the controller's host
        self.ef_state: Dict[Any, Any] = {}
        self.mom_state: Dict[Any, Any] = {}
        self.anon_counter = 0
        self.lock = threading.Lock()
        # the controller's PSWorkers, one a pod controller NIC (psworker
        # is NIC 0's); owners maps a partition key to the controller whose
        # NIC carries it
        self.psworker: Optional[PSWorker] = None
        self.psworkers: List[PSWorker] = []
        self.owners: Optional[OwnerTable] = None
        self.owner_failovers = 0
        # bumped (under lock) by _fail_owner's EF and momentum reset: a
        # COMPRESS that read its state before the bump must not write
        # the stale residual back after it (see _compress_stage)
        self.failover_gen = 0
        # the pipeline's stage names, hybrid REDUCE (caller's thread) first
        self.stages: Tuple[str, ...] = ()
        self.m_reduce = None
        self.inited_keys = set()          # {(owner, key)} initialised
        # hybrid names whose last call is not synchronized yet
        self.inflight = set()
        self.tail: Optional[_Tail] = None
        self.staging: Optional[HostStaging] = None
        self.bytes_d2h = 0
        self.bytes_h2d = 0
        # on_membership_change hooks, and the live pods the last join()
        # adopted (what a rank that is no controller knows of them)
        self.membership_hooks: List[Callable[[int], Any]] = []
        self.live_pods: Optional[int] = None


_state = _EagerState()
_warned = set()


def _warn_once(key: str, msg: str, *args) -> None:
    if key not in _warned:
        _warned.add(key)
        log.warning(msg, *args)


def _m(name: str, kind: str = "histogram"):
    return getattr(get_registry(), kind)(name)


def init(compression_params: Optional[Dict[str, Any]] = None,
         seed: int = 0) -> None:
    """Build this rank's pipeline (reference: ``init``, ``:127``). Call it
    on every rank of the pod, after ``torch.distributed``'s own init when
    the pod has more than one rank. ``compression_params`` is the default
    spec of every call; ``seed`` the base of the stochastic codecs' keys."""
    if _state.initialized:
        return
    cfg = get_config()
    check_ported(cfg)
    # the global group (BYTEPS_JAX_DISTRIBUTED): join it here when the
    # launcher's bootstrap did not (a no-op once joined)
    from byteps_tpu_torch.comm.distributed import maybe_init_distributed

    maybe_init_distributed(cfg)
    _state.cfg = cfg
    _state.registry = TensorRegistry()
    _state.spec = from_params(compression_params)
    _state.seed = int(seed)
    _state.bytes_d2h = _state.bytes_h2d = 0
    n, r = world()
    # not distributed, PUSHPULL and SYNC run in the caller's thread
    # (push_pull_async, synchronize): no scheduler
    if cfg.is_distributed:
        if n > 1:
            backend = dist.get_backend()
            bps_check(backend == "gloo",
                      f"the hybrid pipeline over a {backend} group (not "
                      "ported yet: only gloo has run it)")
        n_ctl = max(1, cfg.pod_controllers) if cfg.hybrid_sharded else 1
        # every rank labels partitions with their owners (credit pools);
        # the controller alone routes by them
        _state.owners = OwnerTable(n_ctl, salt=cfg.owner_salt)
        if r == 0:
            _state.psworkers = [PSWorker() for _ in range(n_ctl)]
            _state.psworker = _state.psworkers[0]
        # REDUCE runs in the caller's thread (_issue_reduce), timed into
        # the stage's own histogram; the scheduler starts at COPYD2H
        _state.m_reduce = _m("scheduler.stage.REDUCE.run_us")
        stages = [
            Stage("COPYD2H", _d2h_stage, pool_size=2),
            Stage("COMPRESS", _compress_stage, credited=True, pool_size=2),
            Stage("PUSH", _push_stage, credited=True, pool_size=4,
                  releases_credit=True, retryable=True,
                  max_attempts=2 + n_ctl),
            Stage("PULL", _pull_stage, pool_size=4, retryable=True,
                  max_attempts=2 + n_ctl),
            Stage("DECOMPRESS", _decompress_stage, pool_size=2),
            Stage("COPYH2D", _h2d_stage, pool_size=2),
        ]
        if cfg.hybrid_sharded:
            stages.append(Stage("ALLGATHER", _allgather_stage, pool_size=2))
        _state.stages = ("REDUCE",) + tuple(s.name for s in stages)
        bps_check(_state.stages == HYBRID_STAGE_ORDER[:len(_state.stages)],
                  "hybrid stage list drifted from HYBRID_STAGE_ORDER")
        _state.staging = HostStaging()
        # the tail's collectives get a group of their own, so that they
        # never interleave with the caller's REDUCE on the default group
        group = dist.new_group(backend="gloo") if n > 1 else None
        _state.tail = _Tail(n, r, group)
        # several controllers scope credits per owner: one faulted NIC
        # backing off does not starve its siblings' wires; bounded
        # staleness keeps up to K+1 rounds of a key in flight
        _state.scheduler = PipelineScheduler(
            stages=stages, credit=cfg.scheduling_credit,
            credit_scope="owner" if n_ctl > 1 else "global",
            rounds_window=cfg.staleness if cfg.staleness > 0 else None)
    _state.initialized = True
    log.info("byteps_tpu_torch.eager initialized: pod %d of %d, rank %d of "
             "%d, %s pipeline, compression=%s", cfg.worker_id,
             max(1, cfg.num_worker), r, n,
             "hybrid" if cfg.is_distributed else "eager ICI",
             _state.spec.compressor.name)


def shutdown() -> None:
    """Stop the pipeline; the controller says goodbye to the servers
    (reference: ``shutdown``, ``:319``)."""
    if _state.scheduler is not None:
        _state.scheduler.shutdown()
        _state.scheduler = None
    if _state.tail is not None:
        _state.tail.close()
        _state.tail = None
    if _state.psworker is not None:
        # one goodbye round a pod, through NIC 0 (servers count one a
        # pod, and every controller shares the pod's worker id); the
        # other NICs retire
        for w in _state.psworkers[1:]:
            retire_nic(w)
        _state.psworker.shutdown()
        _state.psworker = None
    _state.psworkers = []
    _state.owners = None
    _state.membership_hooks.clear()
    _state.live_pods = None
    _state.initialized = False
    _state.stages = ()
    _state.inflight.clear()
    _state.versions.clear()
    _state.ef_state.clear()
    _state.mom_state.clear()
    _state.inited_keys.clear()


def _require_init() -> None:
    bps_check(_state.initialized, "call byteps_tpu_torch.eager.init() first")


# --- topology (reference: byteps_rank/size/local_rank/local_size) -----------
def rank() -> int:
    """This pod's worker id (``DMLC_WORKER_ID``; 0 on one pod)."""
    _require_init()
    return _state.cfg.worker_id


def pod_size() -> int:
    """Ranks in this pod: the default process group's size."""
    _require_init()
    return world()[0]


def size() -> int:
    """Global data-parallel participants: pod ranks × ``DMLC_NUM_WORKER``."""
    return pod_size() * max(1, _state.cfg.num_worker)


def local_rank() -> int:
    _require_init()
    return world()[1]


def local_size() -> int:
    return pod_size()


def _is_controller() -> bool:
    return world()[1] == 0


def _np_dtype(dtype) -> np.dtype:
    """The registry's dtype for a torch dtype: numpy's own, or a void of
    the same width where numpy has none (bfloat16); partitions are cut
    by its itemsize."""
    if isinstance(dtype, torch.dtype):
        try:
            return np.dtype(str(dtype).removeprefix("torch."))
        except TypeError:
            return np.dtype(f"V{torch.empty(0, dtype=dtype).element_size()}")
    return np.dtype(dtype)


def _tensor_rng(name: str, version: int, seed: int = 0) -> int:
    """The key of one call of a tensor (reference ``:405``): CRC32 of the
    name, then the spec's seed, then the version, folded into ``init``'s
    seed — the same on every rank and pod."""
    base = fold_in(_state.seed, zlib.crc32(name.encode()) & 0x7FFFFFFF)
    base = fold_in(base, seed)
    return fold_in(base, version)


# --- the eager ICI pipeline --------------------------------------------------
def _dispatch(task: PartitionTask, chunk: torch.Tensor):
    """PUSHPULL (reference ``_dispatch_stage``, ``:416``), in the caller's
    thread: momentum → error feedback → the (compressed) all-reduce.
    Returns ``(result, event)``, the event recorded behind it on the card
    (None on the CPU), which :func:`synchronize` waits for (SYNC)."""
    ctx = task.context
    spec, average = ctx["spec"], ctx["average"]
    p = task.partition
    if not spec.enabled:
        out = allreduce_flat(chunk, average=average)
    else:
        rng = fold_in(ctx["rng"], p.part_idx)
        skey = (task.name, p.part_idx)
        if spec.momentum:
            m = _state.mom_state.get(skey)
            if m is None:
                m = torch.zeros(chunk.shape, dtype=torch.float32,
                                device=chunk.device)
            chunk, m = momentum_step(chunk.float(), m, spec.mu)
            _state.mom_state[skey] = m
        if spec.ef:
            e = _state.ef_state.get(skey)
            if e is None:
                e = torch.zeros(chunk.shape, dtype=torch.float32,
                                device=chunk.device)
            out, _state.ef_state[skey] = compressed_allreduce_flat(
                chunk, spec.compressor, average=average, two_way=spec.two_way,
                ef_residual=e, rng=rng)
        else:
            out = compressed_allreduce_flat(
                chunk, spec.compressor, average=average, two_way=spec.two_way,
                rng=rng)
    event = None
    if out.is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(out.device))
    return out, event


# --- the hybrid pipeline -----------------------------------------------------
def _issue_reduce(task: PartitionTask, chunk: torch.Tensor):
    """REDUCE (reference ``:463``), in the caller's thread: the pod sum
    of the chunk in its own dtype; sharded, this rank's segment, gathered
    to the controller. On the controller it also starts the f32 copy of
    the sum to the host. Returns the task's payload: on the controller
    what COPYD2H waits for, None elsewhere."""
    cfg, ctx, p = _state.cfg, task.context, task.partition
    spec = ctx["spec"]
    n, r = world()
    sharded = cfg.hybrid_sharded
    t0 = time.perf_counter()
    if (cfg.ici_tier == "ring" and spec.enabled and n > 1
            and p.length * 4 >= cfg.min_compress_bytes):
        rng = fold_in(ctx["rng"], p.part_idx)
        if sharded:
            out = compressed_reduce_scatter_flat(
                chunk, spec.compressor, average=False, rng=rng, tier="ring")
        else:
            out = compressed_allreduce_flat(
                chunk, spec.compressor, average=False, two_way=spec.two_way,
                rng=rng, tier="ring")
    elif sharded:
        out = reduce_scatter_flat(chunk)
    else:
        out = allreduce_flat(chunk, average=False)
    if sharded and n > 1:
        # the segments of the pod sum reach the controller, bits only
        full = out.new_empty(n, out.shape[0]) if r == 0 else None
        dist.gather(out, list(full.unbind(0)) if r == 0 else None, dst=0)
        out = full.reshape(-1) if r == 0 else None
    _state.m_reduce.observe((time.perf_counter() - t0) * 1e6)
    if r != 0:
        return None
    pod_sum = out[:p.length]
    if not pod_sum.is_cuda:
        return np.ascontiguousarray(pod_sum.float().numpy())
    push_t, _ = ctx["pinned"]
    stream = ctx["stream"]
    f = pod_sum.float()
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(f.device))
    stream.wait_event(ready)
    with torch.cuda.stream(stream):
        push_t[p.offset:p.offset + p.length].copy_(f, non_blocking=True)
        f.record_stream(stream)
        done = torch.cuda.Event()
        done.record(stream)
    with _state.lock:
        _state.bytes_d2h += p.length * 4
    _m("dcn.d2h_bytes", "counter").inc(p.length * 4)
    return done, push_t.numpy()[p.offset:p.offset + p.length]


def _d2h_stage(task: PartitionTask):
    """COPYD2H (reference ``:505``): the controller's f32, C-contiguous pod
    sum of the partition on the host; a CUDA tensor's copy is waited for
    here, on a pool thread."""
    got = task.payload
    if isinstance(got, tuple):
        done, host = got
        done.synchronize()
        return host
    return got


def _wire_seed(task: PartitionTask) -> int:
    return wire_seed(task.name, task.context["version"],
                     task.partition.part_idx, salt=task.context["spec"].seed)


def _compress_stage(task: PartitionTask):
    """COMPRESS (reference ``:543``), on the controller: host momentum →
    error feedback → wire encode, in f32 numpy as the reference's."""
    x = task.payload
    if x is None:
        return None
    p = task.partition
    plan = task.context["plans"][p.part_idx]
    if plan is None:
        return x.view(np.uint8).ravel()
    spec = task.context["spec"]
    seed = _wire_seed(task)
    skey = (task.name, p.part_idx)
    # _fail_owner resets the state of the partitions whose owner moved: a
    # write-back of state read before that reset is dropped (one lost
    # update beats resurrecting a residual the reset cleared)
    gen = _state.failover_gen
    if spec.momentum:
        m = _state.mom_state.get(skey)
        if m is None:
            m = np.zeros_like(x)
        m_new = spec.mu * m + x
        x = x + spec.mu * m_new
        with _state.lock:
            if _state.failover_gen == gen:
                _state.mom_state[skey] = m_new
    if spec.ef:
        e = _state.ef_state.get(skey)
        if e is None:
            e = np.zeros_like(x)
        corrected = x + e
        payload = plan.codec.encode(corrected, seed)
        approx = plan.codec.decode(payload, x.size, seed)
        with _state.lock:
            if _state.failover_gen == gen:
                _state.ef_state[skey] = corrected - approx
        return payload
    return plan.codec.encode(x, seed)


def _owner_of(key: int) -> int:
    return _state.owners.owner(key) if _state.owners is not None else 0


def _fail_owner(rank: int, cause: Optional[BaseException] = None) -> bool:
    """Fail controller ``rank`` over (``hand_off_owner``: fence, export,
    adopt, shrink), under the state lock, and drop the error-feedback and
    momentum state of every partition whose owner moved: a dead
    controller's codec state does not migrate, and the residual restarts
    from zero with the remap. False if ``rank`` is already dead or the
    last controller."""
    with _state.lock:
        live = hand_off_owner(_state.psworkers, _state.owners, rank)
        if live is None:
            return False
        moved = {(name, part.part_idx)
                 for name, ctx in _state.registry.snapshot()
                 for part in ctx.partitions
                 if _state.owners.owner_in(part.key, live) == rank}
        for skey in moved:
            _state.ef_state.pop(skey, None)
            _state.mom_state.pop(skey, None)
        _state.failover_gen += 1
        _state.owner_failovers += 1
        survivors = sorted(_state.owners.live())
    if rank != 0:
        # nothing routes through the dead NIC again; NIC 0 stays open,
        # fenced, for the pod's one goodbye round
        retire_nic(_state.psworkers[rank])
    log.warning("pod controller %d gave up its wire (%s); %d partition "
                "state buffer(s) reset, partitions remap to owners %s",
                rank, cause if cause is not None else "requested",
                len(moved), survivors)
    return True


def _owner_giveup(task: PartitionTask, owner: int, e: BaseException):
    """A wire error through ``owner``'s NIC past its retries: fail it over
    and raise stage-retryably, so that the re-run lands on a survivor;
    anything else, or the last controller, re-raises."""
    if len(_state.psworkers) > 1 and owner_wire_death(e):
        remap_dead_owner(task, owner, _state.owners, _fail_owner, _owner_of,
                         e, "wire dead")
    raise e


def _push_stage(task: PartitionTask):
    """PUSH (reference ``:659``), on the controller, through the
    partition's owner: init the key once an owner, pin the round, push
    the payload. An owner that sees no live server while a sibling lives
    fails over; a wire error past the owner's retries fails it over too
    (``_owner_giveup``). With no live server left on the last controller,
    degrade to the pod's REDUCE sum (``BYTEPS_DEGRADED_OK``)."""
    if task.payload is None:
        return None
    p = task.partition
    owner = _owner_of(p.key)
    worker = _state.psworkers[owner]
    if not worker.has_live_servers():
        if len(_state.psworkers) > 1:
            remap_dead_owner(
                task, owner, _state.owners, _fail_owner, _owner_of,
                NoLiveServersError(f"owner {owner} sees no live servers"),
                "lost all servers")
        return degraded_fallback(worker, _state.cfg, task, log,
                                 "the pod-local sum")
    plan = task.context["plans"][p.part_idx]
    store_bytes = (plan.codec.store_elems(p.length) * 4 if plan is not None
                   else p.length * 4)
    with _state.lock:
        needs_init = (owner, p.key) not in _state.inited_keys
    try:
        if needs_init:
            worker.init_key(p.key, store_bytes)
            with _state.lock:
                _state.inited_keys.add((owner, p.key))
        codec_id = plan.codec.codec_id if plan is not None else 0
        # pin the round before the wire attempt: a stage retry, possibly
        # through a survivor after a failover, re-sends the same round
        task.push_version = worker.mint_version(
            p.key, getattr(task, "push_version", None))
        return worker.push_bytes(p.key, task.payload, codec_id,
                                 version=task.push_version)
    except BaseException as e:  # noqa: BLE001 - owner-death classify
        if isinstance(e, WorkerEvictedError):
            # the rejoin adopted the server's watermarks: the stage retry
            # mints afresh (a stale pin is dropped as a replay)
            task.push_version = None
        _owner_giveup(task, owner, e)


def _pull_stage(task: PartitionTask):
    """PULL (reference ``:722``), on the controller, through the
    partition's owner: the round's result, in the plan's pull format, the
    round it was served from and the live count it closed under."""
    if task.payload is None:
        return None
    if isinstance(task.payload, DegradedLocal):
        return task.payload.payload  # DECOMPRESS decodes the pod sum
    p = task.partition
    plan = task.context["plans"][p.part_idx]
    owner = _owner_of(p.key)
    worker = _state.psworkers[owner]
    try:
        if plan is None:
            out = worker.pull_bytes(p.key, p.length * 4, task.payload, 0)
        else:
            out = worker.pull_bytes(p.key, plan.pull_capacity(p.length),
                                    task.payload, plan.pull_codec_id)
    except BaseException as e:  # noqa: BLE001 - owner-death classify
        _owner_giveup(task, owner, e)
    task.round_live = worker.last_round_live()
    task.served_round = worker.last_pull_round()
    return out


def _decompress_stage(task: PartitionTask):
    """DECOMPRESS (reference ``:753``), on the controller: the wire decode
    of the pulled global sum, with the seed of the round it was served
    from, or of a degraded partition's push-side encoding of the pod
    sum."""
    buf = task.payload
    if buf is None:
        return None
    p = task.partition
    plan = task.context["plans"][p.part_idx]
    buf = np.ascontiguousarray(buf)
    if plan is None:
        return buf.view(np.float32)
    if getattr(task, "degraded", False):
        return plan.codec.decode(buf, p.length, _wire_seed(task))
    seed = pull_seed(task.name, task.context["version"], p.part_idx,
                     served_round=getattr(task, "served_round", None),
                     staleness=_state.cfg.staleness,
                     salt=task.context["spec"].seed)
    return plan.decode_pull(buf, p.length, seed)


def _place(task: PartitionTask, g: np.ndarray) -> torch.Tensor:
    """The controller's global sum in the tail's send layout on the
    tensor's device, with its status element (minus the live count of
    the round's epoch; ``_DEGRADED`` for the pod's own sum): unsharded
    ``(L + 1,)``; sharded
    ``(n, seg + 1)``, row r rank r's zero-padded segment. A CUDA tensor's
    sum goes through the name's pinned pull buffer and the copy stream."""
    p, ctx = task.partition, task.context
    L, n = p.length, pod_size()
    dev = ctx["device"]
    seg = -(-L // n)
    sharded = _state.cfg.hybrid_sharded
    flat = torch.zeros(n * seg if sharded else L + 1, dtype=torch.float32,
                       device=dev)
    if dev.type == "cuda":
        _, pull_t = ctx["pinned"]
        host = pull_t[p.offset:p.offset + L]
        np.copyto(host.numpy(), g)
        stream = ctx["stream"]
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            flat[:L].copy_(host, non_blocking=True)
            flat.record_stream(stream)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        with _state.lock:
            _state.bytes_h2d += L * 4
        _m("dcn.h2d_bytes", "counter").inc(L * 4)
    else:
        flat[:L] = torch.from_numpy(g)
    if sharded:
        buf = flat.new_zeros(n, seg + 1)
        buf[:, :seg] = flat.view(n, seg)
        flat = buf
    flat[..., -1] = (_DEGRADED if getattr(task, "degraded", False)
                     else -task.round_live)
    return flat


def _h2d_stage(task: PartitionTask):
    """COPYH2D (reference ``:854``): the controller copies the global sum to
    its card and hands it to the tail thread, which moves it to the pod;
    the other ranks have nothing to hand. Returns the tail's future (this
    stage must not wait on the tail: it runs in FIFO order)."""
    item = task.context["tail"][task.partition.part_idx]
    if task.payload is not None:
        item.put(_place(task, task.payload))
    return item.future


def _allgather_stage(task: PartitionTask):
    """ALLGATHER (reference ``:875``): the tail thread scattered the
    segments and all-gathered them (bits only) and averaged; wait for
    it."""
    fut: concurrent.futures.Future = task.payload
    while not fut.done():
        tail = _state.tail
        if tail is None or tail.closed:
            raise RuntimeError("the eager pipeline was shut down")
        concurrent.futures.wait([fut], timeout=0.1)
    return fut.result()


# the tail's status element: a failed partition, the pod's own sum of a
# degraded one, or, for a global sum, minus the live pods of the epoch
# its round closed under (exact in f32), which divides it on every rank
_FAILED, _DEGRADED = 1, 2


class _TailItem:
    """One partition's place in the tail: the controller's send buffer
    (set by COPYH2D) and the future of the partition's result."""

    __slots__ = ("task", "ready", "buf", "future")

    def __init__(self, task: PartitionTask) -> None:
        self.task = task
        self.ready = threading.Event()
        self.buf: Optional[torch.Tensor] = None
        self.future: concurrent.futures.Future = concurrent.futures.Future()

    def put(self, buf: torch.Tensor) -> None:
        self.buf = buf
        self.ready.set()


class _Tail:
    """One rank's issuer of the pod's tail collectives, first in first out
    by (call, partition), over ``group``: unsharded, the controller's
    broadcast of the global sum; sharded, its scatter of the segments and
    every rank's all-gather. Averages on the device after them: by the
    pod's size × the live pods of the partition's round, or by the pod's
    size for a degraded partition. The controller waits for each
    partition's sum (or its handle's failure, which it sends on as
    ``_FAILED``); the other ranks just take part."""

    def __init__(self, n: int, rank: int, group) -> None:
        self.n, self.rank, self.group = n, rank, group
        self.closed = False
        self._q: "queue.Queue[Optional[_TailItem]]" = queue.Queue()
        self._m_run = _m("eager.tail_us")
        self._thread = threading.Thread(target=self._run, name="bps-tail",
                                        daemon=True)
        self._thread.start()

    def add(self, items: List[_TailItem]) -> None:
        for it in items:
            self._q.put(it)

    def close(self, timeout: float = 30.0) -> None:
        self.closed = True
        self._q.put(None)
        self._thread.join(timeout)
        if self.group is not None and not self._thread.is_alive():
            dist.destroy_process_group(self.group)
            self.group = None

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                break
            if self.rank == 0:
                while not (item.ready.is_set() or item.task.handle.failed()
                           or self.closed):
                    item.ready.wait(0.05)
            # a partition that failed on the controller still tells the
            # pod after a shutdown: the controller's synchronize raised
            # before this collective, the other ranks' wait for it
            if self.closed and not (self.rank == 0
                                    and item.task.handle.failed()):
                item.future.set_exception(
                    RuntimeError("the eager pipeline was shut down"))
                continue
            t0 = time.perf_counter()
            try:
                item.future.set_result(self._collect(item))
            except BaseException as e:  # noqa: BLE001 - to the handle
                item.future.set_exception(e)
            self._m_run.observe((time.perf_counter() - t0) * 1e6)
        while not self._q.empty():
            item = self._q.get()
            if item is not None and not item.future.done():
                item.future.set_exception(
                    RuntimeError("the eager pipeline was shut down"))

    def _collect(self, item: _TailItem) -> torch.Tensor:
        task = item.task
        L, dev = task.partition.length, task.context["device"]
        n, sharded = self.n, _state.cfg.hybrid_sharded
        seg = -(-L // n)
        buf = item.buf
        if self.rank == 0 and buf is None:
            # the partition failed upstream: tell the pod
            buf = torch.zeros((n, seg + 1) if sharded else (L + 1,),
                              dtype=torch.float32, device=dev)
            buf[..., -1] = _FAILED
        if not sharded:
            if buf is None:
                buf = torch.empty(L + 1, dtype=torch.float32, device=dev)
            if n > 1:
                dist.broadcast(buf, src=0, group=self.group)
            status, out = int(buf[L].item()), buf[:L]
        else:
            mine = buf[0] if n == 1 else torch.empty(
                seg + 1, dtype=torch.float32, device=dev)
            if n > 1:
                dist.scatter(mine, list(buf.unbind(0)) if self.rank == 0
                             else None, src=0, group=self.group)
            status = int(mine[seg].item())
            if status != _FAILED:
                out = all_gather_flat(mine[:seg], length=L, group=self.group)
        if status == _FAILED:
            raise RuntimeError(f"partition {task.partition.part_idx} of "
                               f"'{task.name}' failed on the pod controller")
        if task.context["average"]:
            # a degraded partition holds the pod's sum alone: its pod
            # average stands for the global one; a global sum divides by
            # the participants of its round's epoch
            out = out / (n if status == _DEGRADED else n * -status)
        return out


# --- elastic membership (reference ``:776``–``:833``) -----------------------
def _live_size() -> int:
    """Participants under elastic membership: ``pod_size()`` × the live
    pods of the most recently adopted epoch (``size()`` while the
    membership is full). A rank that is no controller knows the live pods
    its last :func:`join` adopted."""
    if _state.psworkers:
        live = min(w.live_pods() for w in _state.psworkers)
    else:
        live = _state.live_pods or _state.cfg.num_worker
    return pod_size() * max(1, live)


def on_membership_change(hook: Callable[[int], Any]) -> None:
    """Register ``hook(live)`` to run after :func:`join` adopted a
    membership change, with the participants it adopted: the place for a
    data-shard remap and an LR rescale (:func:`linear_scale`)."""
    _require_init()
    _state.membership_hooks.append(hook)


def join() -> int:
    """Admit this pod into a running job (reference ``:802``): the
    controller runs the kJoin handshake and the round-watermark adoption
    on every controller NIC (all under the pod's worker id), so the pod
    enters at a round boundary; the adopted live pods reach the pod's
    other ranks by a broadcast on the default group (a collective: every
    rank calls this, from its calling thread). Fires the
    :func:`on_membership_change` hooks with the participants and returns
    them."""
    _require_init()
    for w in _state.psworkers:
        w.join()
    live = _live_size()
    if pod_size() > 1:
        t = torch.tensor([live], dtype=torch.int64)
        dist.broadcast(t, src=0)
        live = int(t.item())
    _state.live_pods = live // pod_size()
    for hook in list(_state.membership_hooks):
        hook(live)
    return live


def linear_scale(base: float, base_live: int, live: int) -> float:
    """The linear LR (or batch) rescale for elastic membership: ``base``
    was tuned at ``base_live`` participants, the job now has ``live``."""
    return base * (live / max(1, base_live))


# --- the user surface ---------------------------------------------------------
def push_pull_async(
    x: torch.Tensor,
    average: bool = True,
    name: Optional[str] = None,
    priority: Optional[int] = None,
    compression_params: Optional[Dict[str, Any]] = None,
) -> Handle:
    """Start the sum (``average``: the mean over ``size()``) of this rank's
    ``x`` over the pod and, distributed, over the pods. Returns a Handle
    for :func:`synchronize`. Reference: ``push_pull_async`` (``:888``).

    Every rank of the pod makes the same calls in the same order, from one
    thread. Distributed, a name's next call comes after
    :func:`synchronize` of its last, and is refused before it (the
    controller reuses the name's pinned host buffers). A name keeps its
    partition keys, priority (declaration order) and error-feedback state
    across calls; an anonymous call gets neither error feedback nor
    momentum."""
    _require_init()
    cfg = _state.cfg
    anonymous = name is None
    with _state.lock:
        if anonymous:
            name = f"byteps_push_pull.anon_{_state.anon_counter}"
            _state.anon_counter += 1
        L = x.numel()
        ctx = _state.registry.declare(name, (L,), _np_dtype(x.dtype))
        if cfg.is_distributed:
            bps_check(name not in _state.inflight,
                      f"push_pull of '{name}' while its last call is not "
                      "synchronized: synchronize that handle first")
            _state.inflight.add(name)
        version = _state.versions.get(name, 0)
        _state.versions[name] = version + 1
    spec = (from_params(compression_params)
            if compression_params is not None else _state.spec)
    if anonymous and spec.enabled and (spec.ef or spec.momentum):
        # error feedback and momentum are state kept by name: a fresh
        # anonymous name a call would never accumulate
        _warn_once("anon", "push_pull called without name= while %s is "
                   "configured: error-feedback/momentum need a stable "
                   "tensor name to persist state — disabled for anonymous "
                   "tensors", spec.compressor.name)
        spec = dataclasses.replace(spec, ef=False, momentum=False)
    plans = None
    if cfg.is_distributed:
        codec = None
        if spec.enabled:
            try:
                codec = make_wire_codec(spec)
            except ValueError:
                _warn_once("nowire", "compressor '%s' has no DCN wire codec "
                           "— hybrid pushes for it ride fp32",
                           spec.compressor.name)
        plans = [None if codec is None
                 or p.length * 4 < cfg.min_compress_bytes
                 else WirePlan(codec, spec.two_way)
                 for p in ctx.partitions]
    elif spec.enabled and L * x.element_size() < cfg.min_compress_bytes:
        spec = from_params(None)    # tiny tensors skip compression
    handle = Handle(name, len(ctx.partitions))
    handle.inner_shape = tuple(x.shape)  # type: ignore[attr-defined]
    handle.dtype = x.dtype               # type: ignore[attr-defined]
    handle.diag = _stall_diag
    shared: Dict[str, Any] = {
        "spec": spec, "average": average, "version": version,
        "plans": plans, "device": x.device,
        "rng": _tensor_rng(name, version, spec.seed)}
    tasks = []
    for p in ctx.partitions:
        overrides: Dict[str, Any] = {}
        if priority is not None:
            overrides["priority"] = priority
        if _state.owners is not None:
            # the owner label is the placement at enqueue (the credit
            # pool); the stages re-resolve it live
            overrides["owner"] = _state.owners.owner(p.key)
        if overrides:
            p = dataclasses.replace(p, **overrides)
        tasks.append(PartitionTask(partition=p, name=name, handle=handle,
                                   context=shared, round=version))
    flat = x.detach().reshape(-1)
    if not cfg.is_distributed:
        for t in tasks:
            p = t.partition
            handle._partition_done(
                p.part_idx, _dispatch(t, flat[p.offset:p.offset + p.length]))
        return handle
    if x.is_cuda and _is_controller():
        shared["stream"] = _state.staging.copy_stream(x.device)
        shared["pinned"] = _state.staging.pinned_buffers(name, L)
    shared["tail"] = [_TailItem(t) for t in tasks]
    _state.tail.add(shared["tail"])
    for t in tasks:
        p = t.partition
        t.payload = _issue_reduce(t, flat[p.offset:p.offset + p.length])
        _state.scheduler.enqueue([t])
    return handle


def synchronize(handle: Handle, timeout: Optional[float] = 120.0
                ) -> torch.Tensor:
    """Wait for ``handle`` and return the result: the partitions put
    together in the input's shape and dtype, on the input's device
    (reference: ``synchronize``, ``:1048``). ``BYTEPS_HANDLE_DEADLINE_MS``
    caps the whole wait, the tail's included."""
    limit, capped = capped_timeout(timeout)
    end = None if limit is None else time.monotonic() + limit
    try:
        results = handle.wait(timeout)
    finally:
        if handle.done():       # its stages are through the pinned buffers
            _state.inflight.discard(handle.name)
    parts = []
    for i in sorted(results):
        r = results[i]
        if isinstance(r, tuple):            # the eager path: SYNC
            r, event = r
            if event is not None:
                event.synchronize()
        elif isinstance(r, concurrent.futures.Future):
            left = None if end is None else max(0.0, end - time.monotonic())
            done, _ = concurrent.futures.wait([r], timeout=left)
            if not done:
                raise StallError(handle.name, limit,
                                 [j for j in sorted(results) if j < i],
                                 len(results), _stall_diag(),
                                 deadline_capped=capped)
            r = r.result()
        parts.append(r)
    flat = parts[0] if len(parts) == 1 else torch.cat(parts)
    return flat.reshape(handle.inner_shape).to(handle.dtype)  # type: ignore


def push_pull(
    x: torch.Tensor,
    average: bool = True,
    name: Optional[str] = None,
    priority: Optional[int] = None,
    compression_params: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """Blocking :func:`push_pull_async` (reference ``:1069``)."""
    return synchronize(
        push_pull_async(x, average, name, priority, compression_params))


def _leaves(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """The leaves of a list, tuple or dict of tensors (a dict in sorted key
    order, as ``jax.tree.flatten`` takes it) and how to rebuild it."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return [tree[k] for k in keys], lambda outs: dict(zip(keys, outs))
    if isinstance(tree, (list, tuple)):
        return list(tree), lambda outs: type(tree)(outs)
    bps_check(torch.is_tensor(tree),
              f"expected a tensor, list, tuple or dict, got {type(tree)}")
    return [tree], lambda outs: outs[0]


def push_pull_tree(grads, average: bool = True, name_prefix: str = "grad"):
    """Aggregate a list, tuple or dict of tensors, declared in order (a
    dict by sorted key), so that earlier leaves get higher priority; the
    same structure comes back (reference ``:1082``)."""
    _require_init()
    leaves, rebuild = _leaves(grads)
    handles = [push_pull_async(leaf, average=average,
                               name=f"{name_prefix}.{i}")
               for i, leaf in enumerate(leaves)]
    return rebuild([synchronize(h) for h in handles])


def broadcast_parameters(params, root_rank: int = 0):
    """Global rank ``root_rank``'s tensors (rank = pod id · pod_size() +
    local rank) on every rank, in the same structure (reference
    ``:1098``; functional, not in place). Distributed: zeros but on the
    root, then an f32 ``push_pull`` with ``average=False`` under one name
    family per structure, so integers stay exact below 2^24. Not
    distributed: ``broadcast_flat`` in each tensor's own dtype."""
    _require_init()
    leaves, rebuild = _leaves(params)
    n = pod_size()
    root_pod, root_row = divmod(root_rank, n)
    if _state.cfg.is_distributed:
        keys = sorted(params) if isinstance(params, dict) else None
        sig_src = repr(keys) + repr([(tuple(t.shape), str(t.dtype))
                                     for t in leaves])
        sig = zlib.crc32(sig_src.encode()) & 0xFFFFFFFF
        is_root = _state.cfg.worker_id == root_pod and local_rank() == root_row
        handles = [push_pull_async(
            leaf if is_root else torch.zeros_like(leaf), average=False,
            name=f"byteps_broadcast.s{sig:08x}.{i}", compression_params={})
            for i, leaf in enumerate(leaves)]
        return rebuild([synchronize(h) for h in handles])
    return rebuild([broadcast_flat(leaf.detach().reshape(-1),
                                   root=root_rank).reshape(leaf.shape)
                    for leaf in leaves])


def broadcast_optimizer_state(opt_state, root_rank: int = 0):
    """Optimizer state is a structure of tensors too."""
    return broadcast_parameters(opt_state, root_rank)


def declare_tensor(name: str, shape, dtype) -> None:
    """Fix a tensor's priority before its first call (reference:
    ``byteps_declare_tensor``, ``:1190``)."""
    _require_init()
    L = int(np.prod(tuple(shape))) if len(tuple(shape)) else 1
    _state.registry.declare(name, (L,), _np_dtype(dtype))


def tuner():
    """The auto-tuner: none (``BYTEPS_AUTO_TUNE`` is not ported yet)."""
    _require_init()
    return None


def auto_tune_enabled() -> bool:
    return get_config().auto_tune


def default_partition_bytes() -> int:
    """The configured ``BYTEPS_PARTITION_BYTES``."""
    return get_config().partition_bytes


def bytes_moved() -> Tuple[int, int]:
    """(bytes pushed, bytes pulled) over the DCN wire by this rank: the
    controller's, summed over its NICs; 0 on the other ranks."""
    return (sum(w.bytes_pushed for w in _state.psworkers),
            sum(w.bytes_pulled for w in _state.psworkers))


def bytes_copied() -> Tuple[int, int]:
    """(bytes copied device to host, host to device) by this rank's hybrid
    stages: the controller's pod sums and global sums of CUDA tensors."""
    with _state.lock:
        return _state.bytes_d2h, _state.bytes_h2d


def _stall_diag() -> Dict[str, Any]:
    """Handle.diag (shared assembly: ``dcn_adapter.stall_diag``: the
    controller's counters, health and live servers a NIC, live owners,
    wire bytes, credits, busy stages), and this rank's copied bytes."""
    return {**stall_diag(_state.psworkers, _state.owners,
                         [_state.scheduler]),
            "bytes_copied": bytes_copied()}
