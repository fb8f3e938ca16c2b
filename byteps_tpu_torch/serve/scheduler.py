"""Iteration-level request scheduler — Orca's continuous batching over
the block-paged KV cache.

Counterpart of ``byteps_tpu/serve/scheduler.py`` for one colocated
replica (role ``"both"``). One :class:`Scheduler` owns a
:class:`~byteps_tpu_torch.serve.paged_cache.PagedKVCache` pool on its
device and drives a three-phase iteration (``step()``):

1. **Admission** — requests whose arrival time has passed join the
   running set as soon as a slot and enough free KV blocks exist: FIFO
   within each tenant, deficit-weighted fair queuing (DWFQ) across
   tenants (``BYTEPS_SERVE_FAIR_QUEUE``, default on; untenanted or
   single-tenant traffic is plain FIFO either way); preempted requests
   re-queue at the front. With the prefix cache on
   (``BYTEPS_SERVE_PREFIX_CACHE``, default) admission first consults the
   pool's radix index under the request's adapter: a hit maps the
   request's leading table entries to shared read-only pages, CoWs the
   divergence block, and starts chunked prefill there.
2. **Prefill** — one prompt chunk (``serve_prefill_chunk`` tokens) per
   iteration for the oldest prefilling request, so a long prompt
   interleaves with everyone else's decode steps. The final chunk's
   last-position logits give the request's first token (TTFT).
3. **Packed decode** — every decoding request joins one device batch of
   ``serve_max_batch`` rows (padded rows write into the scratch block):
   one token per request per iteration at heterogeneous positions.

**Preemption** — when a block allocation fails, the youngest admitted
request is evicted: its blocks free, its committed tokens are kept, and
it re-queues with ``prompt + emitted`` as the recompute prefill input.

**Multi-tenant LoRA** — with an
:class:`~byteps_tpu_torch.serve.adapter_pool.AdapterPool` attached, one
replica serves many fine-tuned variants of its base model: an
adapter-tagged request pins its adapter's pool slot at admission
(all-or-nothing with its KV blocks), its prefill chunks run on the
tenant's grafted tree, and the packed decode step adds each row's own
delta by slot (``ops/segmented_lora.py``; base-model and padded rows
ride the zero slot 0). Per-tenant KV quotas
(``BYTEPS_SERVE_TENANT_QUOTA_BLOCKS``) make a tenant that outgrows its
quota preempt its own youngest request, never a sibling's; the
``serve.tenant<T>.*`` metrics carry the per-tenant view.

**Exactness contract** — greedy (``temperature == 0``) requests emit
token for token what a solo ``make_generate_fn`` run emits, whatever
the batch composition, admission order, chunking or preemption.
Sampled requests draw from a per-row generator seeded from
(seed, position), independent of batch packing.

**Tensor parallelism** — ``tp_axis`` (a mesh ``Axis``) makes one
replica span the ranks of a tp line: each holds its shards of the model
and its kv heads of the pool, and the packed decode step and the prefill
chunks sum their row-parallel products over tp. The ranks then issue
collectives in step only while every host decision is the same on each:
admission, chunking, preemption and prefix hits follow from the requests
and the pool alone. The one input that could differ is the clock that
admission holds arrivals against: each iteration reads it once, on the
line's first rank, and broadcasts it to the others (:meth:`Scheduler.
_now`). The timestamps of the metrics decide nothing and stay each
rank's own. Logits come out of the tp sum the same on every
rank, so the picks agree. An ``AdapterPool`` under a live tp axis is
refused (ROADMAP A.7): its slabs hold whole adapters, as the
reference's do.

Not ported yet (later slices): the speculative lane, disaggregation and
migration, fault plans (and with them the tenant-scoped
``tenant<T>:slow|hang`` rules), the multi-replica ``Router``. The packed
decode step serves dense-MLP families, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from byteps_tpu_torch.common.config import get_config
from byteps_tpu_torch.common.logging import get_logger
from byteps_tpu_torch.common.metrics import get_registry
from byteps_tpu_torch.models.generate import make_pick, make_truncate
from byteps_tpu_torch.models.gpt import GPTConfig
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
class Request:
    """One generation request. ``prompt`` is a 1-D int32 token array;
    the scheduler emits up to ``max_new`` tokens (stopping early at
    ``eos_id`` when set). ``temperature == 0`` is the exact greedy path;
    sampled requests use ``seed``."""

    rid: Any
    prompt: np.ndarray
    max_new: int
    temperature: float = 0.0
    seed: int = 0
    eos_id: Optional[int] = None
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
                 "t_first", "t_last", "preemptions", "tok_s", "idx_seq",
                 "tenant", "slot")

    def __init__(self, req: Request, t_submit: float):
        self.req = req
        self.emitted: List[int] = []
        self.full_input = np.asarray(req.prompt, np.int32).reshape(-1)
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
        self.tok_s: List[float] = []
        # prefix-index version this run last matched against
        self.idx_seq = -1
        self.tenant = req.tenant
        # adapter-pool slot pinned while admitted (None = base model or
        # not admitted)
        self.slot: Optional[int] = None


class NoProgressError(RuntimeError):
    """The drain loop spun without any request advancing — raised
    instead of hanging."""


class Scheduler:
    """One serving replica: continuous admission, chunked prefill,
    packed decode, preemption. ``params`` live on ``device`` (the card
    unless told otherwise), where the pool is allocated too; so does the
    optional ``adapter_pool``. ``tenant_quota_blocks`` and
    ``fair_queue`` default from the config; ``tenant_weights`` scale a
    tenant's DWFQ share (default 1). ``tp_axis``: the replica spans a tp
    line (the module docstring); ``params`` are this rank's shards, and
    every rank of the line serves the same requests."""

    def __init__(self, params, cfg: GPTConfig, *,
                 tp_axis=None,
                 max_batch: Optional[int] = None,
                 block_size: Optional[int] = None,
                 pool_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 quant_cache: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None,
                 adapter_pool=None,
                 tenant_quota_blocks: Optional[int] = None,
                 fair_queue: Optional[bool] = None,
                 tenant_weights: Optional[Dict[Any, float]] = None,
                 device=None,
                 clock=time.monotonic):
        c = get_config()
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
        self._decode = make_paged_decode_fn(cfg, bs, tp_axis)
        self._prefill = make_paged_prefill_fn(cfg, bs, tp_axis)
        self._pick = _make_pick_fn(cfg.vocab_size)
        self._clock = clock
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
            "prefill_tokens": _reg.counter("serve.prefill_tokens"),
            "decode_tokens": _reg.counter("serve.decode_tokens"),
            "prefix_hits": _reg.counter("serve.prefix_hits"),
            "prefix_misses": _reg.counter("serve.prefix_misses"),
            "prefix_saved": _reg.counter("serve.prefix_saved_tokens"),
            # every committed KV row a preemption throws away and the
            # resume must prefill again
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
    def submit(self, req: Request) -> None:
        """Enqueue a request (rids must be unique per replica)."""
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if req.max_new < 1:
            raise ValueError(f"max_new must be >= 1; got {req.max_new}")
        total = prompt.size + req.max_new
        if total > self.cfg.max_seq:
            raise ValueError(f"prompt ({prompt.size}) + max_new "
                             f"({req.max_new}) exceeds cfg.max_seq "
                             f"({self.cfg.max_seq})")
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
        run = _Run(req, self._clock())
        self._runs[req.rid] = run
        self._waiting.append(run)
        self._m["queue_depth"].set(len(self._waiting))

    @property
    def finished(self) -> bool:
        return not self._waiting and not self._running

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
        """The tree a single-request forward (a prefill chunk) runs on:
        the tenant's grafted tree (built from the pool's padded slabs,
        cached per adapter) when the request names an adapter, else the
        base."""
        if run.req.adapter is None:
            return self.params
        return self.adapter_pool.graft(self.params, run.req.adapter)

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

    def _quota_blocked(self, run: _Run) -> bool:
        """Would admitting ``run`` push its tenant past the KV quota?
        Untenanted requests are exempt."""
        if not self._quota or run.tenant is None:
            return False
        return (self._tenant_usage(run.tenant)
                + self.cache.blocks_for(len(run.full_input) + 1)
                > self._quota)

    def _next_admission(self, now: float) -> Optional[_Run]:
        """The admission pick. Candidates are each tenant's OLDEST waiting
        request that has arrived and is not quota-blocked (a blocked
        tenant is skipped without head-blocking its siblings). With fair
        queuing off, or one tenant, the earliest queue position wins:
        plain FIFO. With it on, the tenant with the most credit wins
        (ties to the earliest position)."""
        seen = set()
        cands = []                       # (queue position, run)
        for pos, run in enumerate(self._waiting):
            t = run.tenant
            if t in seen:
                continue
            seen.add(t)                  # younger same-tenant work waits
            if run.req.arrival_s > now:
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
        run.full_input = np.concatenate(
            [np.asarray(run.req.prompt, np.int32),
             np.asarray(run.emitted, np.int32)])
        self._running.remove(run)
        self._waiting.appendleft(run)
        self._m["preempted"].inc()
        self._m["queue_depth"].set(len(self._waiting))

    def _ensure_or_preempt(self, run: _Run, n_tokens: int,
                           write_lo: int, write_hi: int) -> bool:
        """Grow ``run``'s table to ``n_tokens`` and CoW any shared page
        in the write span, preempting the youngest admitted request as
        often as needed. False when ``run`` itself became the victim.
        Growth past the tenant's KV quota first preempts the tenant's
        own youngest run (possibly ``run``), never a sibling's."""
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
                victim = None
                for cand in reversed(self._running):
                    if cand.state in ("prefill", "decode"):
                        victim = cand
                        break
                if victim is None:
                    raise RuntimeError(
                        "KV pool exhausted with no preemptible request — "
                        "pool sizing bug (submit() validates single-"
                        "request fit)")
                self._preempt(victim)
                if victim is run:
                    return False

    # -- the iteration ------------------------------------------------------
    def _admit(self, now: float) -> bool:
        """Phase 1: admission in :meth:`_next_admission`'s order,
        head-blocked on KV blocks (and adapter slots)."""
        progress = False
        while self._waiting and len(self._running) < self._admit_cap:
            run = self._next_admission(now)
            if run is None:
                break
            L = len(run.full_input)
            reserve = L + 1                # prompt rows + the decode slot
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
        if final:
            picked = self._pick(logits[:, -1], [run.req.seed],
                                [run.cache_len], [run.req.temperature])
            run.state = "decode"
            self._commit_token(run, int(picked[0]), self._clock())
        return True

    def _decode_packed(self) -> bool:
        """Phase 3: one token for every decoding request, in one batch."""
        packed: List[_Run] = []
        for run in list(self._running):
            if run.state != "decode":
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
        (an admission, a prefill chunk, or a decoded token)."""
        self._m["iterations"].inc()
        progress = self._admit(self._now())
        progress |= self._prefill_one()
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
