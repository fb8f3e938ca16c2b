"""Iteration-level request scheduler — Orca's continuous batching over
the block-paged KV cache.

Counterpart of ``byteps_tpu/serve/scheduler.py``. One :class:`Scheduler`
is one model replica: it owns a
:class:`~byteps_tpu_torch.serve.paged_cache.PagedKVCache` pool on its
device and drives a four-phase iteration (``step()``):

1. **Admission** — requests whose arrival time has passed join the
   running set as soon as a slot and enough free KV blocks exist: FIFO
   within each tenant, deficit-weighted fair queuing (DWFQ) across
   tenants (``BYTEPS_SERVE_FAIR_QUEUE``, default on; untenanted or
   single-tenant traffic is plain FIFO either way); preempted and
   failed-over requests re-queue at the front. With the prefix cache on
   (``BYTEPS_SERVE_PREFIX_CACHE``, default) admission first consults the
   pool's radix index under the request's adapter: a hit maps the
   request's leading table entries to shared read-only pages, CoWs the
   divergence block, and starts chunked prefill there.
2. **Prefill** — one prompt chunk (``serve_prefill_chunk`` tokens) per
   iteration for the oldest prefilling request, so a long prompt
   interleaves with everyone else's decode steps. The final chunk's
   last-position logits give the request's first token (TTFT).
3. **Speculative lane** — every request with a :class:`SpecPolicy` runs
   one propose/verify round per iteration instead of a decode step:
   ``spec_len`` proposed tokens (prompt lookup, or a draft model over a
   dense per-request draft cache) verified in one paged prefill chunk of
   ``spec_len`` rows and committed through ``speculative._verify_commit``,
   the arithmetic of ``make_speculative_generate_fn``, so the greedy
   output is plain greedy's at any accept rate. Spec requests never join
   the packed step: a token committed outside the round would desync the
   draft cache. The rewind is the dense one's twin: ``cache_len``
   advances by the committed count and later writes overwrite the rest.
4. **Packed decode** — every other decoding request joins one device
   batch of ``serve_max_batch`` rows (padded rows write into the scratch
   block): one token per request per iteration at heterogeneous
   positions.

**Preemption** — when a block allocation fails, the youngest admitted
request is evicted: its blocks free, its committed tokens are kept, and
it re-queues with ``prompt + emitted`` as the recompute prefill input
(or, behind a router with migration armed, its blocks move to a sibling
instead: migrate-don't-evict).

**Multi-tenant LoRA** — with an
:class:`~byteps_tpu_torch.serve.adapter_pool.AdapterPool` attached, one
replica serves many fine-tuned variants of its base model: an
adapter-tagged request pins its adapter's pool slot at admission
(all-or-nothing with its KV blocks), its prefill chunks and verify
rounds run on the tenant's grafted tree, and the packed decode step adds
each row's own delta by slot (``ops/segmented_lora.py``; base-model and
padded rows ride the zero slot 0). Per-tenant KV quotas
(``BYTEPS_SERVE_TENANT_QUOTA_BLOCKS``) make a tenant that outgrows its
quota preempt its own youngest request, never a sibling's; the
``serve.tenant<T>.*`` metrics carry the per-tenant view.

**Exactness contract** — greedy (``temperature == 0``) requests emit
token for token what a solo ``make_generate_fn`` run emits, whatever
the batch composition, admission order, chunking, preemption,
speculation, failover or migration. Sampled requests draw from a
per-row generator seeded from (seed, position), independent of batch
packing.

**Fault plans** — a replica ticks its
:class:`~byteps_tpu_torch.common.faults.FaultPlan` (``fault_plan=``, else
``BYTEPS_FAULT_SPEC`` under ``worker_id = replica_id``) once an
iteration (op ``"serve"``): a ``worker:kill`` or ``replica<N>:kill``
rule kills the replica at an exact step (every later step raises
``WorkerKilledError``, so the router's lease sweep evicts it by its
silence), ``hang`` stalls the iteration. With ``tenant<T>:`` rules in
the plan, each iteration also makes one tenant-attributed intercept per
waiting tenant: ``slow`` makes that tenant's admission pay the latency,
``hang`` skips the tenant's admission for the iteration without
head-blocking its siblings.

**Disaggregation** — ``role="prefill"`` replicas run chunked prefill
only: they stream each newly full KV block to the decode target through
the router's ``stream_blocks`` hook (``serve/kv_wire.py``) and park a
finished prefill in the ``handoff`` state (first token committed, so
TTFT is stamped here) until the router migrates it. ``role="decode"``
replicas adopt migrated requests through the refcount/radix path
(:meth:`Scheduler.submit_migrated`), so prefix sharing survives the wire.
Each role builds only its own steps, on first use.

**Tensor parallelism** — ``tp_axis`` (a mesh ``Axis``) makes one
replica span the ranks of a tp line: each holds its shards of the model
and its kv heads of the pool, and the packed decode step, the prefill
chunks, the verify rounds and the draft steps sum their row-parallel
products over tp. The ranks then issue collectives in step only while
every host decision is the same on each: admission, chunking, preemption
and prefix hits follow from the requests and the pool alone. The one
input that could differ is the clock that admission holds arrivals
against: each iteration reads it once, on the line's first rank, and
broadcasts it to the others (:meth:`Scheduler._now`). The timestamps of
the metrics decide nothing and stay each rank's own. Logits come out of
the tp sum the same on every rank, so the picks agree. An
``AdapterPool`` under a live tp axis is refused (ROADMAP A.7): its slabs
hold whole adapters, as the reference's do.

The packed decode step serves dense-MLP families, as the reference's
does. Not ported yet: the KV wire over a socket (``serve/kv_socket.py``,
the router's ``kv_target_wrap``), which waits for the process tier's
socket NIC (``common/socknic.py``, ROADMAP A.8).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from byteps_tpu_torch.common.config import get_config
from byteps_tpu_torch.common.faults import (
    FaultPlan,
    WorkerKilledError,
    plan_from_env,
)
from byteps_tpu_torch.common.flight_recorder import get_flight_recorder
from byteps_tpu_torch.common.logging import get_logger
from byteps_tpu_torch.common.metrics import get_registry
from byteps_tpu_torch.models.generate import (
    gpt_apply_cached,
    init_cache,
    make_pick,
    make_truncate,
)
from byteps_tpu_torch.models.gpt import GPTConfig
from byteps_tpu_torch.models.speculative import _verify_commit
from byteps_tpu_torch.ops.backend import resolve_device
from byteps_tpu_torch.serve.paged_cache import (
    PagedKVCache,
    PoolExhausted,
    make_paged_decode_fn,
    make_paged_prefill_fn,
)

log = get_logger("serve.scheduler")

# replica instance sequence for per-replica gauge series
_REPLICA_SEQ = itertools.count()


def _row_seed(seed: int, pos: int) -> int:
    """The generator seed of one sampled pick: a fixed function of the
    request's seed and the absolute position, so the draw is the same
    whatever batch the row rides in."""
    return (int(seed) * 1_000_003 + int(pos)) & 0x7FFF_FFFF_FFFF_FFFF


def _make_pick_fn(vocab_size: int):
    """Token pick for a batch of rows: ``pick(logits (R, V), seeds, pos,
    temps) -> (R,) int32 numpy``. The greedy/sampled arm is
    ``generate.make_pick``, so the greedy contract cannot drift from
    ``make_generate_fn``'s; sampled rows get their own generator."""
    pick1 = make_pick(make_truncate(None, None, vocab_size))

    def pick(logits: torch.Tensor, seeds, pos, temps) -> np.ndarray:
        out = torch.argmax(logits, dim=-1).to(torch.int32)
        for r in np.flatnonzero(np.asarray(temps) > 0.0):
            g = torch.Generator(device=logits.device)
            g.manual_seed(_row_seed(seeds[r], pos[r]))
            out[r] = pick1(logits[r:r + 1], g, float(temps[r]))[0]
        return out.cpu().numpy()

    return pick


@dataclasses.dataclass
class SpecPolicy:
    """Per-request speculative decoding policy (greedy only: the verify
    compares greedy argmax).

    ``kind="lookup"`` — prompt-lookup drafting: propose the ``spec_len``
    tokens that followed the latest earlier occurrence of the committed
    context's last bigram (``make_lookup_generate_fn``'s proposal, on the
    host). ``kind="draft"`` — a draft model sharing the target's vocab
    (``draft_params`` on the replica's device, ``draft_cfg``):
    ``spec_len`` greedy draft steps against a dense per-request draft
    cache (``make_speculative_generate_fn``'s proposal). ``spec_len`` 0
    takes ``BYTEPS_SERVE_SPEC_LEN``."""

    kind: str = "lookup"
    spec_len: int = 0
    draft_params: Any = None
    draft_cfg: Optional[GPTConfig] = None

    def __post_init__(self):
        if self.kind not in ("lookup", "draft"):
            raise ValueError(f"unknown spec kind {self.kind!r}")
        if self.kind == "draft" and (self.draft_params is None
                                     or self.draft_cfg is None):
            raise ValueError("draft policy needs draft_params + draft_cfg")


@dataclasses.dataclass
class Request:
    """One generation request. ``prompt`` is a 1-D int32 token array;
    the scheduler emits up to ``max_new`` tokens (stopping early at
    ``eos_id`` when set). ``temperature == 0`` is the exact greedy path;
    sampled requests use ``seed``; ``spec`` decodes it speculatively."""

    rid: Any
    prompt: np.ndarray
    max_new: int
    temperature: float = 0.0
    seed: int = 0
    eos_id: Optional[int] = None
    spec: Optional[SpecPolicy] = None
    arrival_s: float = 0.0
    # ``tenant`` keys fair queuing, KV quotas and the per-tenant metrics
    # (None = untenanted, exempt from quotas); ``adapter`` names a LoRA
    # adapter registered in the replica's AdapterPool (None = the bare
    # base model)
    tenant: Any = None
    adapter: Any = None


class _Run:
    """Scheduler-internal per-request state."""

    __slots__ = ("req", "full_input", "emitted", "pending", "cache_len",
                 "prefill_done", "state", "t_submit", "t_origin", "t_admit",
                 "t_first", "t_last", "preemptions", "spec_rounds",
                 "draft_cache", "tok_s", "idx_seq", "streamed", "tenant",
                 "slot")

    def __init__(self, req: Request, resume_tokens: List[int],
                 t_submit: float):
        self.req = req
        self.emitted: List[int] = list(resume_tokens)
        self.full_input = np.concatenate(
            [np.asarray(req.prompt, np.int32).reshape(-1),
             np.asarray(self.emitted, np.int32)])
        self.pending: Optional[int] = None
        self.cache_len = 0
        self.prefill_done = 0
        self.state = "queued"
        self.t_submit = t_submit
        # latency origin: the request's arrival, not an earlier submit
        self.t_origin = max(t_submit, req.arrival_s)
        self.t_admit = 0.0
        self.t_first: Optional[float] = None
        self.t_last = self.t_origin
        self.preemptions = 0
        self.spec_rounds = 0
        # the dense draft-model cache of a draft-policy request
        self.draft_cache = None
        self.tok_s: List[float] = []
        # prefix-index version this run last matched against
        self.idx_seq = -1
        # full blocks already streamed to the decode target (prefill
        # role): each block crosses the wire once
        self.streamed = 0
        self.tenant = req.tenant
        # adapter-pool slot pinned while admitted (None = base model or
        # not admitted)
        self.slot: Optional[int] = None


class NoProgressError(RuntimeError):
    """The drain loop spun without any request advancing — raised
    instead of hanging."""


class Scheduler:
    """One serving replica: continuous admission, chunked prefill,
    speculative rounds, packed decode, preemption. ``params`` live on
    ``device`` (the card unless told otherwise), where the pool is
    allocated too; so does the optional ``adapter_pool``.
    ``tenant_quota_blocks`` and ``fair_queue`` default from the config;
    ``tenant_weights`` scale a tenant's DWFQ share (default 1).
    ``tp_axis``: the replica spans a tp line (the module docstring);
    ``params`` are this rank's shards, and every rank of the line serves
    the same requests.

    ``fault_plan`` (default: ``BYTEPS_FAULT_SPEC`` under ``worker_id =
    replica_id``) and ``role`` (``"both"``, ``"prefill"`` or
    ``"decode"``) as in the module docstring."""

    def __init__(self, params, cfg: GPTConfig, *,
                 tp_axis=None,
                 max_batch: Optional[int] = None,
                 block_size: Optional[int] = None,
                 pool_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 quant_cache: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 replica_id: int = 0,
                 role: str = "both",
                 adapter_pool=None,
                 tenant_quota_blocks: Optional[int] = None,
                 fair_queue: Optional[bool] = None,
                 tenant_weights: Optional[Dict[Any, float]] = None,
                 device=None,
                 clock=time.monotonic):
        c = get_config()
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"unknown scheduler role {role!r} "
                             "(expected both|prefill|decode)")
        self.device = resolve_device(device)
        if params["wte"].device != self.device:
            raise ValueError(f"params live on {params['wte'].device}, the "
                             f"scheduler on {self.device}")
        if adapter_pool is not None and adapter_pool.device != self.device:
            raise ValueError(f"the adapter pool lives on "
                             f"{adapter_pool.device}, the scheduler on "
                             f"{self.device}")
        tp_live = tp_axis is not None and tp_axis.size > 1
        if tp_live and adapter_pool is not None:
            raise NotImplementedError(
                "an AdapterPool under a live tp axis is not ported yet "
                "(ROADMAP A.7): the pool's slabs hold whole adapters, as "
                "the reference's AdapterPool does, so its multi-tenant "
                "step cannot run sharded")
        self.params = params
        self.cfg = cfg
        self.tp_axis = tp_axis
        self._tp_live = tp_live
        self.role = role
        self.replica_id = replica_id
        self.adapter_pool = adapter_pool
        self._quota = tenant_quota_blocks if tenant_quota_blocks \
            is not None else c.serve_tenant_quota_blocks
        if self._quota < 0:
            raise ValueError(
                f"tenant_quota_blocks must be >= 0; got {self._quota}")
        self._fair = fair_queue if fair_queue is not None \
            else c.serve_fair_queue
        self._weights: Dict[Any, float] = dict(tenant_weights or {})
        for t, w in self._weights.items():
            if w <= 0:
                raise ValueError(
                    f"tenant weight must be > 0; got {w} for {t!r}")
        # DWFQ deficit credits of the tenants with waiting work; the max
        # renormalizes to 0 after every admission, so an idle tenant
        # banks no credit while away
        self._credits: Dict[Any, float] = {}
        self._tm: Dict[Any, Dict[str, Any]] = {}
        self.max_batch = max_batch if max_batch is not None \
            else c.serve_max_batch
        self.prefill_chunk = prefill_chunk if prefill_chunk is not None \
            else c.serve_prefill_chunk
        self.default_spec_len = c.serve_spec_len
        self._prefix_on = prefix_cache if prefix_cache is not None \
            else c.serve_prefix_cache
        quant = quant_cache if quant_cache is not None \
            else c.serve_quant_cache
        bs = block_size if block_size is not None else c.serve_block_size
        nb = pool_blocks if pool_blocks is not None else c.serve_pool_blocks
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1; got {self.max_batch}")
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1; got {self.prefill_chunk}")
        if cfg.max_seq % bs != 0:
            log.warning(
                "serve: block_size %d does not divide max_seq %d — the "
                "gathered views carry a zero tail past max_seq (correct, "
                "slightly wasteful)", bs, cfg.max_seq)
        # under tp the pool holds this rank's kv heads (its wk shard)
        kv_loc = params["blocks"][0]["wk"].shape[-1] // cfg.head_dim
        self.cache = PagedKVCache(cfg, block_size=bs, pool_blocks=nb,
                                  max_batch=self.max_batch, h_loc=kv_loc,
                                  quant=quant, device=self.device)
        # each role builds its steps on first use: a prefill replica
        # never builds the packed decode step, and a decode replica fed
        # by migration never a prefill chunk
        self._decode_fn = None
        self._prefill_fn = None
        self._pick = _make_pick_fn(cfg.vocab_size)
        self._plan = fault_plan if fault_plan is not None \
            else plan_from_env(worker_id=replica_id)
        self._dead = False
        self._clock = clock
        # disaggregation hooks, installed by the router (None =
        # colocated): stream_blocks(sched, run, {block_idx: BlockPayload})
        # pushes newly committed prefill blocks onto the KV wire;
        # migrate_out(sched, run) -> bool moves a preemption victim's
        # blocks to a sibling instead of evicting it (True = extracted)
        self.stream_blocks = None
        self.migrate_out = None
        # wire-delivered payloads staged until adoption, {rid: {block_idx:
        # BlockPayload}}: written by KVWire push threads (ingest_block),
        # drained on this replica's thread at adoption
        self._staging: Dict[Any, Dict[int, Any]] = {}
        self._staging_lock = threading.Lock()
        self._kv_codec = None
        self._waiting: deque = deque()
        self._running: List[_Run] = []
        self._runs: Dict[Any, _Run] = {}
        self.results: Dict[Any, Dict[str, Any]] = {}
        # admit a little past the decode-slot count so a finished
        # request's slot refills from a prefilled standby
        self._admit_cap = self.max_batch + max(1, self.max_batch // 4)
        _reg = get_registry()
        self._m = {
            "admitted": _reg.counter("serve.admitted"),
            "completed": _reg.counter("serve.completed"),
            "preempted": _reg.counter("serve.preempted"),
            "resumed": _reg.counter("serve.resumed"),
            "prefill_tokens": _reg.counter("serve.prefill_tokens"),
            "decode_tokens": _reg.counter("serve.decode_tokens"),
            "spec_rounds": _reg.counter("serve.spec_rounds"),
            "spec_tokens": _reg.counter("serve.spec_tokens"),
            "prefix_hits": _reg.counter("serve.prefix_hits"),
            "prefix_misses": _reg.counter("serve.prefix_misses"),
            "prefix_saved": _reg.counter("serve.prefix_saved_tokens"),
            # the migration plane: requests that left and arrived over
            # the KV wire, the KV tokens that moved instead of being
            # recomputed, and the recompute bill of every eviction
            "migrated_out": _reg.counter("serve.migration.out_requests"),
            "migrated_in": _reg.counter("serve.migration.in_requests"),
            "migrated_tokens": _reg.counter("serve.migration.tokens"),
            "recompute_tokens": _reg.counter(
                "serve.migration.recompute_tokens"),
            "iterations": _reg.counter("serve.iterations"),
            "ttft_ms": _reg.histogram("serve.ttft_ms"),
            "token_ms": _reg.histogram("serve.token_ms"),
            "request_ms": _reg.histogram("serve.request_ms"),
            "batch_occupancy": _reg.histogram("serve.batch_occupancy"),
            # per-replica series: two replicas' queues must not mask
            # each other
            "queue_depth": _reg.gauge(
                f"serve.r{next(_REPLICA_SEQ)}.queue_depth"),
        }

    # -- client surface -----------------------------------------------------
    def submit(self, req: Request,
               resume_tokens: Optional[List[int]] = None) -> None:
        """Enqueue a request (rids must be unique per replica).
        ``resume_tokens``: the router's failover path — tokens already
        committed on a dead replica, kept verbatim and recomputed into
        fresh KV."""
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if req.max_new < 1:
            raise ValueError(f"max_new must be >= 1; got {req.max_new}")
        spec_k = 0
        if req.spec is not None:
            if req.temperature != 0.0:
                raise ValueError(
                    "speculative policies are greedy-only "
                    "(verification compares greedy argmax)")
            spec_k = req.spec.spec_len or self.default_spec_len
            if spec_k < 1:
                raise ValueError(
                    f"effective spec_len must be >= 1; got {spec_k} "
                    "(policy spec_len or BYTEPS_SERVE_SPEC_LEN)")
        total = prompt.size + req.max_new + spec_k
        if total > self.cfg.max_seq:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new ({req.max_new})"
                + (f" + spec_len ({spec_k})" if spec_k else "")
                + f" exceeds cfg.max_seq ({self.cfg.max_seq})")
        if self.cache.blocks_for(total) > self.cache.pool_blocks - 1:
            raise ValueError(
                f"request needs {self.cache.blocks_for(total)} KV blocks "
                f"but the pool holds {self.cache.pool_blocks - 1} — it "
                "could never be scheduled")
        if (self._quota and req.tenant is not None
                and self.cache.blocks_for(total) > self._quota):
            raise ValueError(
                f"request needs {self.cache.blocks_for(total)} KV blocks "
                f"but tenant {req.tenant!r}'s quota is {self._quota} — "
                "it could never run under the quota")
        if req.adapter is not None:
            if self.adapter_pool is None:
                raise ValueError(
                    f"request names adapter {req.adapter!r} but this "
                    "replica has no adapter pool")
            if not self.adapter_pool.registered(req.adapter):
                raise ValueError(
                    f"adapter {req.adapter!r} is not registered in the pool")
        if req.rid in self._runs:
            raise ValueError(f"duplicate request id {req.rid!r}")
        if req.adapter is not None:
            # warm a FREE slot now (never evicts), so admission's
            # acquire is a residency hit
            self.adapter_pool.prefetch(req.adapter)
        run = _Run(req, list(resume_tokens or []), self._clock())
        self._runs[req.rid] = run
        if resume_tokens:
            self._waiting.appendleft(run)   # failover work is the oldest
            self._m["resumed"].inc()
        else:
            self._waiting.append(run)
        self._m["queue_depth"].set(len(self._waiting))

    @property
    def load(self) -> int:
        """Routing weight: queued + running requests."""
        return len(self._waiting) + len(self._running)

    @property
    def finished(self) -> bool:
        return not self._waiting and not self._running

    @property
    def dead(self) -> bool:
        return self._dead

    def result(self, rid) -> Dict[str, Any]:
        return self.results[rid]

    def drain_incomplete(self):
        """Pop every unfinished request (queued and running), freeing
        their blocks: ``[(Request, emitted_tokens), ...]`` for the router
        to re-queue on a survivor. Completed results stay readable."""
        out = []
        for run in list(self._running):
            self.cache.release(run.req.rid)
            self._release_adapter(run)
            out.append((run.req, list(run.emitted)))
            del self._runs[run.req.rid]
        self._running.clear()
        while self._waiting:
            run = self._waiting.popleft()
            out.append((run.req, list(run.emitted)))
            del self._runs[run.req.rid]
        self._m["queue_depth"].set(0)
        return out

    # -- disaggregation / migration surface ---------------------------------
    def ingest_block(self, rid, block_idx: int, buf) -> None:
        """KV-wire delivery, on a KVWire push thread: decode the frame
        (its CRC checked: a corruption raises into the wire's retry) and
        stage the payload until adoption. Idempotent per (rid, block).
        The device is never touched here: adoption scatters on this
        replica's own thread."""
        payload = self.kv_codec.decode(buf)
        with self._staging_lock:
            self._staging.setdefault(rid, {})[int(block_idx)] = payload

    def staged_blocks(self, rid) -> set:
        with self._staging_lock:
            return set(self._staging.get(rid, ()))

    def pop_staged(self, rid) -> Dict[int, Any]:
        with self._staging_lock:
            return self._staging.pop(rid, {})

    def drop_staged(self, rid) -> None:
        with self._staging_lock:
            self._staging.pop(rid, None)

    def _cut_ticket(self, run: _Run, nb: int, payloads):
        from byteps_tpu_torch.serve.kv_wire import MigrationTicket

        return MigrationTicket(
            req=run.req, emitted=list(run.emitted), pending=run.pending,
            cache_len=run.cache_len,
            full_input=np.concatenate(
                [np.asarray(run.req.prompt, np.int32).reshape(-1),
                 np.asarray(run.emitted, np.int32)]),
            n_blocks=nb, payloads=payloads, t_origin=run.t_origin,
            t_submit=run.t_submit, t_first=run.t_first,
            tok_s=list(run.tok_s), preemptions=run.preemptions,
            spec_rounds=run.spec_rounds)

    def pop_handoffs(self):
        """Prefill role: a :class:`~byteps_tpu_torch.serve.kv_wire.
        MigrationTicket` for every request whose prefill (and first
        token) completed, carrying the blocks not streamed yet (the
        partial tail). The run parks in the ``migrating`` state, its
        blocks pinned, until :meth:`finish_handoff` (so a failed
        migration can always re-stream from live pages)."""
        out = []
        for run in self._running:
            if run.state != "handoff":
                continue
            nb = self.cache.blocks_for(run.cache_len)
            out.append(self._cut_ticket(
                run, nb, self.cache.snapshot_blocks(run.req.rid,
                                                    run.streamed, nb)))
            run.state = "migrating"
        return out

    def finish_handoff(self, rid) -> None:
        """Adoption confirmed on the decode target: release the parked
        run's blocks (shared prefix pages stay for the next sharer)."""
        run = self._runs.pop(rid)
        self._running.remove(run)
        self.cache.release(rid)
        self._release_adapter(run)

    def extract_for_migration(self, rid):
        """Migrate-don't-evict: take a decoding victim out of this
        replica — snapshot all its committed blocks, free them, and
        return the ticket the router ships to a sibling. Unlike
        :meth:`_preempt`, nothing is recomputed."""
        run = self._runs.pop(rid)
        self._running.remove(run)
        nb = self.cache.blocks_for(run.cache_len)
        ticket = self._cut_ticket(run, nb,
                                  self.cache.snapshot_blocks(rid, 0, nb))
        self.cache.release(rid)
        self._release_adapter(run)
        run.state = "migrated"
        self._m["migrated_out"].inc()
        get_flight_recorder().record_event(
            "serve.migrate_out",
            {"replica": self.replica_id, "rid": str(rid), "blocks": nb,
             "tokens": run.cache_len})
        return ticket

    def submit_migrated(self, ticket, payloads) -> bool:
        """Adopt a migrated request: its KV blocks (``payloads``, as the
        wire delivered them) enter this pool through the refcount/radix
        path — leading blocks the local index already holds are shared,
        not duplicated, the rest scatter bit-exact, and the whole context
        is committed to the index. Returns False, allocating nothing,
        when the pool cannot fit the request even after preemption (the
        router then recomputes through a plain ``submit``)."""
        req = ticket.req
        rid = req.rid
        if rid in self._runs:
            raise ValueError(f"duplicate request id {rid!r}")
        if req.adapter is not None and (
                self.adapter_pool is None
                or not self.adapter_pool.registered(req.adapter)):
            raise ValueError(
                f"migrated request {rid!r} names adapter {req.adapter!r} "
                "but this replica's pool does not hold it — the router "
                "must register every adapter on every decode-capable "
                "replica")
        missing = [bi for bi in range(ticket.n_blocks) if bi not in payloads]
        if missing:
            raise ValueError(
                f"migration for {rid!r} is missing block(s) {missing}")
        run = _Run(req, list(ticket.emitted),
                   ticket.t_submit or self._clock())
        ctx = run.full_input           # prompt + emitted == rows [0, len)
        self.cache.register(rid)
        hit_blocks: List[int] = []
        if self._prefix_on:
            hit_blocks, hit_tokens = self.cache.match_prefix(
                ctx[:ticket.cache_len], full_blocks_only=True,
                namespace=req.adapter)
            if hit_blocks:
                self.cache.adopt_prefix(rid, hit_blocks)
                self._m["prefix_hits"].inc()
                self._m["prefix_saved"].inc(hit_tokens)
        hit_n = len(hit_blocks)
        while True:
            try:
                self.cache.ensure(rid, ticket.cache_len + 1)
                break
            except PoolExhausted:
                victim = next((cand for cand in reversed(self._running)
                               if cand.state in ("prefill", "decode")), None)
                if victim is None:
                    # cannot fit even with the pool drained: roll back,
                    # the router recomputes instead
                    self.cache.release(rid)
                    return False
                if (self.migrate_out is not None
                        and victim.state == "decode"
                        and victim.req.spec is None
                        and self.migrate_out(self, victim)):
                    continue
                self._preempt(victim)
        if req.adapter is not None:
            try:
                run.slot = self.adapter_pool.acquire(req.adapter, rid)
            except PoolExhausted:
                # every adapter slot pinned: roll back, as for the blocks
                self.cache.release(rid)
                return False
        row = self.cache.table_row(rid)
        self.cache.write_payloads(
            [int(b) for b in row[hit_n:ticket.n_blocks]],
            [payloads[bi] for bi in range(hit_n, ticket.n_blocks)])
        if self._prefix_on:
            self.cache.commit_prefix(rid, ctx, ticket.cache_len,
                                     namespace=req.adapter)
        run.cache_len = ticket.cache_len
        run.prefill_done = ticket.cache_len
        run.pending = ticket.pending
        run.t_origin = ticket.t_origin
        run.t_first = ticket.t_first
        run.t_last = ticket.tok_s[-1] if ticket.tok_s else ticket.t_origin
        run.tok_s = list(ticket.tok_s)
        run.preemptions = ticket.preemptions
        run.spec_rounds = ticket.spec_rounds
        run.state = "decode"
        if req.spec is not None and req.spec.kind == "draft":
            # the draft cache over everything but the pending token (the
            # draft proposes from it); drafts move speed, never content
            self._build_draft_cache(run, tokens=ctx[:-1])
        self._runs[rid] = run
        self._running.append(run)
        self._m["migrated_in"].inc()
        self._m["migrated_tokens"].inc(ticket.cache_len)
        get_flight_recorder().record_event(
            "serve.migrate_in",
            {"replica": self.replica_id, "rid": str(rid),
             "blocks": ticket.n_blocks, "shared": hit_n,
             "tokens": ticket.cache_len})
        return True

    @property
    def kv_codec(self):
        """This replica's KV-block wire codec (both ends of a migration
        must agree: ``KVBlockCodec.decode`` checks)."""
        if self._kv_codec is None:
            from byteps_tpu_torch.serve.kv_wire import KVBlockCodec

            self._kv_codec = KVBlockCodec.from_pool(self.cache)
        return self._kv_codec

    # -- the steps, built per role on first use -----------------------------
    @property
    def _prefill(self):
        """The paged prefill chunk (also the verify round's forward)."""
        if self._prefill_fn is None:
            self._prefill_fn = make_paged_prefill_fn(
                self.cfg, self.cache.block_size, self.tp_axis)
        return self._prefill_fn

    @_prefill.setter
    def _prefill(self, fn) -> None:
        self._prefill_fn = fn

    @property
    def _decode(self):
        """The packed decode step. A prefill replica never gets here:
        reaching it would mean the router's role split leaked decode
        work onto the prefill tier."""
        if self._decode_fn is None:
            if self.role == "prefill":
                raise RuntimeError(
                    "prefill-only replica asked for the packed decode "
                    "step — the router's role split is broken")
            self._decode_fn = make_paged_decode_fn(
                self.cfg, self.cache.block_size, self.tp_axis)
        return self._decode_fn

    @_decode.setter
    def _decode(self, fn) -> None:
        self._decode_fn = fn

    def _width(self, rid) -> int:
        """Power-of-two bucket of the request's live table, so a short
        request never pays a max_seq-wide gather."""
        n = self.cache.table_len(rid)
        w = 1
        while w < n:
            w <<= 1
        return min(w, self.cache.blocks_per_req)

    def _table(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64),
                               device=self.device)

    def _params_for(self, run: _Run):
        """The tree a single-request forward (a prefill chunk, a verify
        round) runs on: the tenant's grafted tree (built from the pool's
        padded slabs, cached per adapter) when the request names an
        adapter, else the base."""
        if run.req.adapter is None:
            return self.params
        return self.adapter_pool.graft(self.params, run.req.adapter)

    def _draft_forward(self, run: _Run, tokens, cache, readout=True):
        """One cached forward of ``run``'s draft model over ``tokens``
        (host ints, (T,)), under the replica's tp axis: ``(logits,
        cache)``."""
        pol = run.req.spec
        t = torch.as_tensor(np.asarray(tokens, np.int32)[None],
                            device=self.device)
        return gpt_apply_cached(pol.draft_params, t, cache, pol.draft_cfg,
                                self.tp_axis, readout=readout)

    # -- multi-tenant policy -------------------------------------------------
    def _tenant_m(self, tenant) -> Dict[str, Any]:
        """Lazy per-tenant metrics (``serve.tenant<T>.*``): untenanted
        traffic keeps the plain metric surface."""
        m = self._tm.get(tenant)
        if m is None:
            _reg = get_registry()
            p = f"serve.tenant{tenant}"
            m = self._tm[tenant] = {
                "admitted": _reg.counter(f"{p}.admitted"),
                "tokens": _reg.counter(f"{p}.tokens"),
                "quota_hits": _reg.counter(f"{p}.quota_hits"),
                "ttft_ms": _reg.histogram(f"{p}.ttft_ms"),
            }
        return m

    def _tenant_usage(self, tenant) -> int:
        """KV blocks the tenant's admitted requests hold (table lengths:
        a shared prefix page charges every sharer)."""
        return sum(self.cache.table_len(r.req.rid)
                   for r in self._running if r.tenant == tenant)

    def _reserve(self, run: _Run) -> int:
        """The rows admission reserves: the prompt's, and the decode
        slot's except on a prefill replica (that slot belongs to the
        decode target's pool)."""
        L = len(run.full_input)
        return L if self.role == "prefill" else L + 1

    def _quota_blocked(self, run: _Run) -> bool:
        """Would admitting ``run`` push its tenant past the KV quota?
        Untenanted requests are exempt."""
        if not self._quota or run.tenant is None:
            return False
        return (self._tenant_usage(run.tenant)
                + self.cache.blocks_for(self._reserve(run)) > self._quota)

    def _next_admission(self, now: float, deferred=()) -> Optional[_Run]:
        """The admission pick. Candidates are each tenant's OLDEST waiting
        request that has arrived, is not quota-blocked and whose tenant
        is not fault-deferred (a blocked tenant is skipped without
        head-blocking its siblings). With fair queuing off, or one
        tenant, the earliest queue position wins: plain FIFO. With it on,
        the tenant with the most credit wins (ties to the earliest
        position)."""
        seen = set()
        cands = []                       # (queue position, run)
        for pos, run in enumerate(self._waiting):
            t = run.tenant
            if t in seen:
                continue
            seen.add(t)                  # younger same-tenant work waits
            if run.req.arrival_s > now:
                continue
            if t is not None and str(t) in deferred:
                continue
            if self._quota_blocked(run):
                self._tenant_m(t)["quota_hits"].inc()
                continue
            cands.append((pos, run))
        if not cands:
            return None
        if not self._fair:
            return cands[0][1]
        for _, run in cands:
            self._credits.setdefault(run.tenant, 0.0)
        return max(cands, key=lambda pr: (self._credits[pr[1].tenant],
                                          -pr[0]))[1]

    def _charge_admission(self, run: _Run, reserve: int) -> None:
        """DWFQ accounting of one admission: the tenant pays its block
        reservation over its weight, then credits of the tenants with
        waiting work (and the payer) shift so their max is 0."""
        if not self._fair:
            return
        t = run.tenant
        w = float(self._weights.get(t, 1.0))
        self._credits[t] = (self._credits.get(t, 0.0)
                            - self.cache.blocks_for(reserve) / w)
        active = {r.tenant for r in self._waiting}
        active.add(t)
        mx = max(self._credits.get(a, 0.0) for a in active)
        self._credits = {a: self._credits.get(a, 0.0) - mx for a in active}

    def _release_adapter(self, run: _Run) -> None:
        """Unpin the run's adapter slot (idempotent); the adapter stays
        resident, cached-idle."""
        if run.slot is not None:
            self.adapter_pool.release(run.req.adapter, run.req.rid)
            run.slot = None

    # -- internals ----------------------------------------------------------
    def _commit_token(self, run: _Run, tok: int, now: float) -> None:
        """Append one generated token, stamp latencies, finish when
        max_new is reached or eos is emitted."""
        run.emitted.append(tok)
        run.pending = tok
        run.tok_s.append(now)
        if run.tenant is not None:
            self._tenant_m(run.tenant)["tokens"].inc()
        if run.t_first is None:
            run.t_first = now
            self._m["ttft_ms"].observe((now - run.t_origin) * 1e3)
            if run.tenant is not None:
                self._tenant_m(run.tenant)["ttft_ms"].observe(
                    (now - run.t_origin) * 1e3)
        else:
            self._m["token_ms"].observe((now - run.t_last) * 1e3)
        run.t_last = now
        if (len(run.emitted) >= run.req.max_new
                or (run.req.eos_id is not None and tok == run.req.eos_id)):
            self._finish(run, now)

    def _finish(self, run: _Run, now: float) -> None:
        self.cache.release(run.req.rid)
        self._release_adapter(run)
        self._running.remove(run)
        del self._runs[run.req.rid]
        run.state = "done"
        prompt = np.asarray(run.req.prompt, np.int32).reshape(-1)
        emitted = np.asarray(run.emitted[:run.req.max_new], np.int32)
        self.results[run.req.rid] = {
            "tokens": np.concatenate([prompt, emitted]),
            "emitted": emitted,
            "ttft_s": (run.t_first - run.t_origin
                       if run.t_first is not None else None),
            "total_s": now - run.t_origin,
            "token_s": np.asarray(run.tok_s[:run.req.max_new]),
            "preemptions": run.preemptions,
            "spec_rounds": run.spec_rounds,
        }
        self._m["completed"].inc()
        self._m["request_ms"].observe((now - run.t_origin) * 1e3)

    def _preempt(self, run: _Run) -> None:
        """Evict ``run``: free its blocks, keep its committed tokens,
        re-queue it at the front to recompute prompt + emitted."""
        self._m["recompute_tokens"].inc(run.cache_len)
        self.cache.release(run.req.rid)
        self._release_adapter(run)
        run.state = "queued"
        run.preemptions += 1
        run.pending = None
        run.cache_len = 0
        run.prefill_done = 0
        run.streamed = 0
        run.draft_cache = None
        run.full_input = np.concatenate(
            [np.asarray(run.req.prompt, np.int32).reshape(-1),
             np.asarray(run.emitted, np.int32)])
        self._running.remove(run)
        self._waiting.appendleft(run)
        self._m["preempted"].inc()
        self._m["queue_depth"].set(len(self._waiting))
        get_flight_recorder().record_event(
            "serve.preempt",
            {"replica": self.replica_id, "rid": str(run.req.rid),
             "emitted": len(run.emitted)})

    def _ensure_or_preempt(self, run: _Run, n_tokens: int,
                           write_lo: int, write_hi: int) -> bool:
        """Grow ``run``'s table to ``n_tokens`` and CoW any shared page
        in the write span, preempting the youngest admitted request as
        often as needed. False when ``run`` itself left (preempted, or
        migrated out). Growth past the tenant's KV quota first preempts
        the tenant's own youngest run (possibly ``run``), never a
        sibling's."""
        if self._quota and run.tenant is not None:
            while True:
                need = (self.cache.blocks_for(n_tokens)
                        - self.cache.table_len(run.req.rid))
                if (need <= 0 or self._tenant_usage(run.tenant) + need
                        <= self._quota):
                    break
                self._tenant_m(run.tenant)["quota_hits"].inc()
                victim = next(
                    (cand for cand in reversed(self._running)
                     if cand.tenant == run.tenant and cand is not run
                     and cand.state in ("prefill", "decode")), run)
                self._preempt(victim)
                if victim is run:
                    return False
        while True:
            try:
                self.cache.ensure(run.req.rid, n_tokens)
                self.cache.ensure_writable(run.req.rid, write_lo, write_hi)
                return True
            except PoolExhausted:
                victim = next((cand for cand in reversed(self._running)
                               if cand.state in ("prefill", "decode")), None)
                if victim is None:
                    raise RuntimeError(
                        "KV pool exhausted with no preemptible request — "
                        "pool sizing bug (submit() validates single-"
                        "request fit)")
                # migrate-don't-evict: a decoding victim's blocks can move
                # to a sibling over the KV wire (the router's hook);
                # the victim may be ``run`` itself (cross-replica load
                # shedding). Mid-prefill and spec victims are evicted:
                # their partial or draft state does not travel.
                if (self.migrate_out is not None
                        and victim.state == "decode"
                        and victim.req.spec is None
                        and self.migrate_out(self, victim)):
                    if victim is run:
                        return False
                    continue
                self._preempt(victim)
                if victim is run:
                    return False

    # -- speculative lane ---------------------------------------------------
    def _lookup_propose(self, run: _Run, K: int) -> np.ndarray:
        """Prompt-lookup draft on the host: the continuation of the
        latest earlier occurrence of the committed context's last bigram
        (``make_lookup_generate_fn``'s proposal, in numpy). No match:
        zeros, which accept nothing."""
        ctx = np.concatenate(
            [np.asarray(run.req.prompt, np.int32).reshape(-1),
             np.asarray(run.emitted, np.int32)])
        n = ctx.size
        if n < 2:
            return np.zeros(K, np.int32)
        prev, last = int(ctx[-2]), int(ctx[-1])
        match = np.flatnonzero((ctx[:-1] == prev) & (ctx[1:] == last))
        match = match[match <= n - 3]   # strictly earlier than the bigram
        if match.size == 0:
            return np.zeros(K, np.int32)
        p = int(match[-1])
        idx = np.clip(p + 2 + np.arange(K), 0, n - 1)
        return ctx[idx].astype(np.int32)

    def _draft_propose(self, run: _Run, K: int):
        """K greedy draft-model steps against the request's dense draft
        cache. Returns ``(proposals (K,), the draft fill level before the
        round)``: the rewind's anchor."""
        dc = run.draft_cache
        len0 = dc.length
        tok = run.pending
        d = []
        for _ in range(K):
            lg, dc = self._draft_forward(run, [tok], dc)
            tok = int(torch.argmax(lg[0, -1]))
            d.append(tok)
        run.draft_cache = dc
        return np.asarray(d, np.int32), len0

    def _spec_round(self, run: _Run, now: float) -> None:
        """One propose → verify → commit round of a spec-policy request:
        ``K`` rows at ``pos0`` through the paged prefill chunk, committed
        by ``speculative._verify_commit``."""
        pol = run.req.spec
        K = pol.spec_len or self.default_spec_len
        pos0 = run.cache_len
        if not self._ensure_or_preempt(run, pos0 + K, pos0, pos0 + K):
            return
        draft_len0 = None
        if pol.kind == "draft":
            d, draft_len0 = self._draft_propose(run, K)
        else:
            d = self._lookup_propose(run, K)
        feed = np.concatenate([[run.pending], d[:K - 1]]).astype(np.int32)
        logits = self._prefill(
            self._params_for(run), self.cache.state,
            torch.as_tensor(feed[None], device=self.device), pos0,
            self._table(self.cache.table_row(run.req.rid,
                                             self._width(run.req.rid))))
        out = torch.zeros((1, K + 1), dtype=torch.int32, device=self.device)
        out, n, next_tok, committed = _verify_commit(
            torch.as_tensor(d[None], device=self.device), logits, out, 0, K)
        block = out[0, :n].cpu().numpy()
        run.cache_len = pos0 + committed
        if pol.kind == "draft":
            run.draft_cache = run.draft_cache._replace(
                length=draft_len0 + committed)
        run.spec_rounds += 1
        self._m["spec_rounds"].inc()
        self._m["spec_tokens"].inc(n)
        # the round emits [d_1..d_m (, correction)]; commit them one by
        # one so eos or max_new stops mid-block as the dense sampler's
        # truncation does
        for t in block:
            if run.state != "decode":
                return                       # finished mid-block
            self._commit_token(run, int(t), now)
        if run.state == "decode":
            run.pending = int(next_tok[0])

    def _build_draft_cache(self, run: _Run,
                           tokens: Optional[np.ndarray] = None) -> None:
        """Prefill the request's dense draft cache over its committed
        context (a migrated-in run passes its context minus the pending
        token)."""
        pol = run.req.spec
        kv_d = (pol.draft_params["blocks"][0]["wk"].shape[-1]
                // pol.draft_cfg.head_dim)
        dc = init_cache(pol.draft_cfg, 1, h_loc=kv_d, device=self.device)
        _, run.draft_cache = self._draft_forward(
            run, run.full_input if tokens is None else tokens, dc,
            readout=False)

    # -- the iteration ------------------------------------------------------
    def _replica_fault(self) -> None:
        """This iteration's tick of the replica's fault plan: ``kill``
        raises, for good; ``hang`` stalls the iteration."""
        inj = self._plan.intercept("serve", -1)
        if inj is None:
            return
        if inj.kind == "kill":
            self._dead = True
            get_flight_recorder().record_event(
                "serve.replica_killed",
                {"replica": self.replica_id, "step": self._plan.step})
            raise WorkerKilledError(
                f"serve replica {self.replica_id} killed by fault plan at "
                f"op {self._plan.step}")
        if inj.kind == "hang":
            time.sleep(inj.rule.latency_ms / 1e3)

    def _tenant_faults(self) -> set:
        """One tenant-attributed tick per waiting tenant, made only when
        the plan holds tenant rules (so tenant-free specs keep their step
        windows): ``slow`` sleeps inside the tick, ``hang`` defers the
        tenant's admission. Returns the deferred tenants."""
        deferred: set = set()
        if (self._plan is None or not self._plan.has_tenant_rules()
                or not self._waiting):
            return deferred
        for t in sorted({str(r.tenant) for r in self._waiting
                         if r.tenant is not None}):
            inj = self._plan.intercept("serve", -1, tenant=t)
            if inj is not None and inj.kind == "hang":
                deferred.add(t)
        return deferred

    def _admit(self, now: float, deferred=()) -> bool:
        """Phase 1: admission in :meth:`_next_admission`'s order,
        head-blocked on KV blocks (and adapter slots)."""
        progress = False
        while self._waiting and len(self._running) < self._admit_cap:
            run = self._next_admission(now, deferred)
            if run is None:
                break
            L = len(run.full_input)
            reserve = self._reserve(run)
            hit_blocks: List[int] = []
            hit_tokens = 0
            if self._prefix_on:
                # capped at L-1 tokens so the final prefill chunk always
                # runs (its last logits give the first token)
                hit_blocks, hit_tokens = self.cache.match_prefix(
                    run.full_input[:L - 1], namespace=run.req.adapter)
                run.idx_seq = self.cache.index_version
            partial = 1 if hit_tokens % self.cache.block_size else 0
            need = self.cache.blocks_for(reserve) - len(hit_blocks) + partial
            if partial and need > (self.cache.free_blocks
                                   + self.cache.reclaimable_blocks(
                                       exclude=hit_blocks)):
                # a partial-divergence hit costs one extra block and pins
                # an evictable page; on a tight pool drop it — the
                # full-block hit alone is never worse than cold
                hit_blocks = hit_blocks[:-1]
                hit_tokens -= hit_tokens % self.cache.block_size
                partial = 0
                need = self.cache.blocks_for(reserve) - len(hit_blocks)
            if need > (self.cache.free_blocks
                       + self.cache.reclaimable_blocks(exclude=hit_blocks)):
                break
            self._waiting.remove(run)
            self.cache.register(run.req.rid)
            try:
                if hit_blocks:
                    self.cache.adopt_prefix(run.req.rid, hit_blocks)
                self.cache.ensure(run.req.rid, reserve)
                if partial:
                    # the match ends mid-block: CoW the divergence block
                    self.cache.ensure_writable(run.req.rid, hit_tokens,
                                               hit_tokens + 1)
                if run.req.adapter is not None:
                    # pin the adapter's slot for the run's lifetime,
                    # all-or-nothing with the KV blocks
                    run.slot = self.adapter_pool.acquire(run.req.adapter,
                                                         run.req.rid)
            except PoolExhausted:
                # roll back losslessly and retry next iteration
                self.cache.release(run.req.rid)
                self._waiting.appendleft(run)
                break
            if self._prefix_on:
                if hit_tokens:
                    self._m["prefix_hits"].inc()
                    self._m["prefix_saved"].inc(hit_tokens)
                else:
                    self._m["prefix_misses"].inc()
            # a hit starts chunked prefill at the divergence
            run.prefill_done = hit_tokens
            run.cache_len = hit_tokens
            run.state = "prefill"
            run.t_admit = now
            self._running.append(run)
            self._charge_admission(run, reserve)
            self._m["admitted"].inc()
            if run.tenant is not None:
                self._tenant_m(run.tenant)["admitted"].inc()
            self._m["queue_depth"].set(len(self._waiting))
            progress = True
        return progress

    def _prefill_one(self) -> bool:
        """Phase 2: one chunk for the oldest prefilling request."""
        run = next((r for r in self._running if r.state == "prefill"), None)
        if run is None:
            return False
        L = len(run.full_input)
        if (self._prefix_on and run.prefill_done < L - 1
                and run.idx_seq != self.cache.index_version):
            # re-consult the index mid-prefill: a sibling admitted
            # alongside may have committed the shared prefix since
            bs = self.cache.block_size
            run.idx_seq = self.cache.index_version
            hit_blocks, jump = self.cache.match_prefix(
                run.full_input[:L - 1], full_blocks_only=True,
                namespace=run.req.adapter)
            if jump > run.prefill_done:
                bp = run.prefill_done // bs
                self.cache.readopt_prefix(run.req.rid,
                                          hit_blocks[bp:jump // bs], bp)
                self._m["prefix_hits"].inc()
                self._m["prefix_saved"].inc(jump - run.prefill_done)
                run.prefill_done = jump
                run.cache_len = jump
        C = min(self.prefill_chunk, L - run.prefill_done)
        toks = run.full_input[run.prefill_done:run.prefill_done + C]
        final = run.prefill_done + C == L
        # the chunk scatters C rows: CoW any shared page in its span
        self.cache.ensure_writable(run.req.rid, run.prefill_done,
                                   run.prefill_done + C)
        logits = self._prefill(
            self._params_for(run), self.cache.state,
            torch.as_tensor(toks[None], device=self.device),
            run.prefill_done,
            self._table(self.cache.table_row(run.req.rid,
                                             self._width(run.req.rid))),
            readout=final)
        run.prefill_done += C
        run.cache_len = run.prefill_done
        self._m["prefill_tokens"].inc(C)
        if self._prefix_on:
            # publish the newly full leading blocks for later sharers
            self.cache.commit_prefix(run.req.rid, run.full_input,
                                     run.prefill_done,
                                     namespace=run.req.adapter)
        if self.role == "prefill" and self.stream_blocks is not None:
            # newly full blocks go onto the KV wire now, so their wire
            # time overlaps the next chunk's compute; the partial tail
            # travels with the handoff ticket
            full = run.prefill_done // self.cache.block_size
            if full > run.streamed:
                self.stream_blocks(
                    self, run, self.cache.snapshot_blocks(
                        run.req.rid, run.streamed, full))
                run.streamed = full
        if final:
            picked = self._pick(logits[:, -1], [run.req.seed],
                                [run.cache_len], [run.req.temperature])
            run.state = "decode"
            if (run.req.spec is not None and run.req.spec.kind == "draft"
                    and self.role != "prefill"):
                self._build_draft_cache(run)
            self._commit_token(run, int(picked[0]), self._clock())
            if run.state == "decode" and self.role == "prefill":
                # the request parks, blocks pinned, until the router
                # migrates it; its first token is committed, so TTFT was
                # stamped here, untouched by wire time
                run.state = "handoff"
        return True

    def _spec_lane(self) -> bool:
        """Phase 3: one round for every decoding spec request."""
        spec = [r for r in self._running
                if r.state == "decode" and r.req.spec is not None]
        for run in spec:
            if run.state == "decode":       # an earlier round may preempt
                self._spec_round(run, self._clock())
        return bool(spec)

    def _decode_packed(self) -> bool:
        """Phase 4: one token for every other decoding request, in one
        batch."""
        packed: List[_Run] = []
        for run in list(self._running):
            if run.state != "decode" or run.req.spec is not None:
                continue
            if len(packed) >= self.max_batch:
                break
            if self._ensure_or_preempt(run, run.cache_len + 1,
                                       run.cache_len, run.cache_len + 1):
                packed.append(run)
        packed = [r for r in packed if r.state == "decode"]
        if not packed:
            return False
        R = self.max_batch
        W = max(self._width(r.req.rid) for r in packed)
        toks = np.zeros(R, np.int64)
        pos = np.zeros(R, np.int64)
        tables = np.zeros((R, W), np.int64)
        seeds = np.zeros(R, np.int64)
        temps = np.zeros(R, np.float32)
        for i, run in enumerate(packed):
            toks[i] = run.pending
            pos[i] = run.cache_len
            tables[i] = self.cache.table_row(run.req.rid, W)
            seeds[i] = run.req.seed
            temps[i] = run.req.temperature
        pooled = ()
        if self.adapter_pool is not None:
            # each row adds its adapter's delta by pool slot; padded and
            # base-model rows ride the zero slot 0
            slots = np.zeros(R, np.int32)
            for i, run in enumerate(packed):
                if run.slot is not None:
                    slots[i] = run.slot
            pooled = (self.adapter_pool.slabs,
                      torch.as_tensor(slots, device=self.device))
        logits = self._decode(self.params, self.cache.state,
                              self._table(toks), self._table(pos),
                              self._table(tables), *pooled)
        picked = self._pick(logits, seeds, pos + 1, temps)
        now = self._clock()
        for i, run in enumerate(packed):
            run.cache_len += 1
            self._commit_token(run, int(picked[i]), now)
        self._m["decode_tokens"].inc(len(packed))
        self._m["batch_occupancy"].observe(len(packed))
        return True

    def _now(self) -> float:
        """The clock reading that admission decides on: under a live tp
        axis the line's first rank's, broadcast over the line (one
        collective, which every rank issues once an iteration)."""
        if not self._tp_live:
            return self._clock()
        ax = self.tp_axis
        t = torch.tensor([self._clock() if ax.index == 0 else 0.0],
                         dtype=torch.float64)
        torch.distributed.broadcast(t, src=ax.ranks[0], group=ax.group)
        return float(t[0])

    def step(self) -> bool:
        """One scheduler iteration; True when any request made progress
        (an admission, a prefill chunk, a spec round, or a decoded
        token). A dead replica raises ``WorkerKilledError``."""
        if self._dead:
            raise WorkerKilledError(
                f"serve replica {self.replica_id} is dead")
        if self._plan is not None:
            self._replica_fault()
        self._m["iterations"].inc()
        now = self._now()
        progress = self._admit(now, self._tenant_faults())
        progress |= self._prefill_one()
        progress |= self._spec_lane()
        progress |= self._decode_packed()
        return progress

    def serve(self, requests: List[Request], max_idle_iters: int = 10000):
        """Submit and drain: run ``step()`` until every request finished.
        Arrival times are honoured against this scheduler's clock."""
        for r in requests:
            self.submit(r)
        idle = 0
        while not self.finished:
            if self.step():
                idle = 0
                continue
            idle += 1
            now = self._now()
            if self._waiting and all(r.req.arrival_s > now
                                     for r in self._waiting):
                time.sleep(1e-4)
            elif idle > max_idle_iters:
                raise NoProgressError(
                    f"{len(self._waiting)} queued / {len(self._running)} "
                    f"running requests made no progress for "
                    f"{max_idle_iters} iterations")
        return self.results
