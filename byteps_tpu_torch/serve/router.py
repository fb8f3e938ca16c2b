"""Multi-replica request routing with lease/epoch replica liveness — the
port's ``byteps_tpu/serve/router.py``.

Death is detected by silence, never by exception identity, as the DCN
tier's worker leases detect it: a member silent past its lease is
evicted, the epoch bumps, and open work moves to the live set.
:class:`Router` holds serve replicas to the same rules:

* every completed ``Scheduler.step()`` renews the replica's lease;
* a replica silent past ``serve_replica_lease_ms`` — crashed, wedged, or
  killed by a ``worker:kill`` / ``replica<N>:kill`` fault rule — is
  evicted: the routing epoch bumps (stamped on every completed result)
  and its unfinished requests re-queue on the survivors;
* a re-queued request keeps its committed tokens and recomputes its KV
  on the survivor (recompute-on-resume), so a greedy request's output
  equals an undisturbed run's: failover moves work, never content.

Dispatch is least-loaded over the live set. The router is
single-threaded: one ``run()`` loop steps every replica in turn.

With a :class:`~byteps_tpu_torch.common.autoscaler.ScalingPolicy` and a
``spawn`` callback it also scales: one policy tick per step observes the
per-replica queue depth (and TTFT-SLO pressure), spawns a replica on
``admit`` and drains the least-loaded one on ``evict``; every decision,
the lease sweep's evictions included, goes through ``record_decision``.

With ``prefill_replicas`` it disaggregates: long prompts run on
dedicated ``role="prefill"`` replicas whose KV blocks stream over a
:class:`~byteps_tpu_torch.serve.kv_wire.KVWire` to a decode target, and
``migrate_preempt`` turns pool-pressure preemption into
migrate-don't-evict. ``kv_target_wrap`` moves the wire's delivery onto
another surface, e.g. a real TCP link (``serve/kv_socket.py``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from byteps_tpu_torch.common.autoscaler import (
    ScalingPolicy,
    record_decision,
    serve_sample,
)
from byteps_tpu_torch.common.config import get_config
from byteps_tpu_torch.common.faults import WorkerKilledError
from byteps_tpu_torch.common.flight_recorder import get_flight_recorder
from byteps_tpu_torch.common.logging import get_logger
from byteps_tpu_torch.common.metrics import get_registry
from byteps_tpu_torch.serve.scheduler import Request, Scheduler

log = get_logger("serve.router")


class NoLiveReplicasError(RuntimeError):
    """Every replica is dead or evicted — nothing can serve."""


class Router:
    """Lease/epoch routing over a set of :class:`Scheduler` replicas.

    ``policy``/``spawn`` arm replica autoscaling (a policy without
    ``spawn``, or one allowed below one replica, would record decisions
    the router cannot carry out, so both are refused). ``ttft_slo_ms``
    adds TTFT pressure to the policy's load, over each tick's window of
    the ``serve.ttft_ms`` histogram.

    ``prefill_replicas`` arms disaggregation: ``role="prefill"``
    replicas whose committed KV blocks stream to a decode target over a
    :class:`~byteps_tpu_torch.serve.kv_wire.KVWire` a source replica
    (paced at ``wire_mbps``, ``BYTEPS_SERVE_DISAGG_MBPS``; ``wire_credit``
    blocks in flight). Inputs of ``prompt_threshold`` tokens or more (a
    quarter of it when the decode pools run at most 25 % free) go to the
    prefill tier and migrate to their decode target; shorter ones
    prefill in place on a decode replica. ``migrate_preempt``: wherever
    two or more decode replicas live, a pool-pressure preemption victim's
    blocks move to the roomiest sibling instead of being freed and
    recomputed.

    ``kv_target_wrap`` swaps the migration wire's delivery surface: it
    maps a resolved decode Scheduler to whatever should receive its
    ``ingest_block`` calls — e.g. a
    :class:`~byteps_tpu_torch.serve.kv_socket.SocketKVTarget`, so the
    block bytes cross a real TCP link. Only the resolve callback handed
    to the ``KVWire`` is wrapped; the router's own adoption bookkeeping
    (``staged_blocks``/``pop_staged``/``submit_migrated``) still talks to
    the local scheduler object."""

    def __init__(self, replicas: List[Scheduler],
                 lease_ms: Optional[int] = None,
                 clock=time.monotonic,
                 policy: Optional[ScalingPolicy] = None,
                 spawn: Optional[Callable[[], Scheduler]] = None,
                 ttft_slo_ms: Optional[float] = None,
                 prefill_replicas: Optional[List[Scheduler]] = None,
                 wire_mbps: Optional[float] = None,
                 wire_credit: Optional[int] = None,
                 prompt_threshold: Optional[int] = None,
                 migrate_preempt: Optional[bool] = None,
                 kv_target_wrap: Optional[Callable[[Scheduler], Any]]
                 = None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        if policy is not None:
            if spawn is None:
                raise ValueError(
                    "a Router policy needs a spawn callback: the policy "
                    "records every decision it makes, and an admit the "
                    "router cannot execute would be a phantom event")
            if policy.min_units < 1:
                raise ValueError(
                    "Router policy min_units must be >= 1: the router "
                    "cannot drain its last replica")
        c = get_config()
        self.replicas = list(replicas) + list(prefill_replicas or [])
        self._prefill_ids = set(range(len(replicas), len(self.replicas)))
        for i in self._prefill_ids:
            if self.replicas[i].role != "prefill":
                raise ValueError(
                    f"prefill_replicas[{i - len(replicas)}] has role "
                    f"{self.replicas[i].role!r} — construct it with "
                    "Scheduler(..., role='prefill')")
        self.lease_ms = lease_ms if lease_ms is not None \
            else c.serve_replica_lease_ms
        self._clock = clock
        now = clock()
        self._beat: Dict[int, float] = {i: now
                                        for i in range(len(self.replicas))}
        self._live = set(range(len(self.replicas)))
        # -- disaggregation / migration plane -------------------------------
        self._wire_mbps = wire_mbps if wire_mbps is not None \
            else c.serve_disagg_mbps
        self._wire_credit = wire_credit if wire_credit is not None \
            else c.serve_disagg_credit
        self._prompt_threshold = prompt_threshold \
            if prompt_threshold is not None \
            else c.serve_disagg_prompt_threshold
        self._migrate_preempt = migrate_preempt \
            if migrate_preempt is not None else c.serve_disagg_migrate
        self._kv_target_wrap = kv_target_wrap
        # rid -> decode-target index, remapped when the target dies; read
        # by KVWire push threads, hence the lock
        self._mig_lock = threading.Lock()
        self._assignment: Dict[Any, int] = {}
        # rid -> in-flight migration: ticket, source index, whether the
        # source still pins the blocks (prefill handoff) or freed them
        # (migrate-out), the payload store (the retransmit source: a dead
        # target costs a re-send, never the request) and per-block wire
        # handles
        self._migrations: Dict[Any, Dict[str, Any]] = {}
        self._stream_store: Dict[Any, Dict[int, Any]] = {}
        self._stream_handles: Dict[Any, Dict[int, Any]] = {}
        self._stream_src: Dict[Any, int] = {}
        self._wires: Dict[int, Any] = {}
        if self._prefill_ids or (self._migrate_preempt
                                 and len(self.replicas) > 1):
            # every migration-capable replica shares one pool layout: the
            # codec frames the pool's own bytes, so a mismatch is a
            # construction error, not a retryable one (stubs without a
            # pool sit the check out)
            keys = {i: self._codec_key(self.replicas[i])
                    for i in range(len(self.replicas))
                    if hasattr(self.replicas[i], "cache")}
            if len(set(keys.values())) > 1:
                raise ValueError(
                    "migration needs every replica on one pool layout "
                    f"(block_size, kv shape, dtype, quant); got {keys}")
        for i in self._prefill_ids:
            self.replicas[i].stream_blocks = self._make_stream_cb(i)
        if self._migrate_preempt:
            for i in range(len(self.replicas)):
                if i not in self._prefill_ids \
                        and hasattr(self.replicas[i], "cache"):
                    self.replicas[i].migrate_out = self._migrate_out
        self.epoch = 0
        self.results: Dict[Any, Dict[str, Any]] = {}
        self._policy = policy
        self._spawn = spawn
        self._ttft_slo_ms = ttft_slo_ms
        # (count, sum) of serve.ttft_ms at the previous autoscale tick:
        # SLO pressure reads the window since, not the process lifetime
        self._ttft_mark = (0, 0.0)
        _reg = get_registry()
        self._m_dispatch = _reg.counter("serve.router.dispatched")
        self._m_evict = _reg.counter("serve.router.evictions")
        self._m_requeued = _reg.counter("serve.router.requeued")
        self._m_mig_done = _reg.counter("serve.migration.adopted")
        self._m_mig_fallback = _reg.counter(
            "serve.migration.fallback_recompute")
        self._m_mig_retarget = _reg.counter("serve.migration.retargets")
        self._g_epoch = _reg.gauge("serve.router.epoch")
        self._g_live = _reg.gauge("serve.router.live_replicas")
        self._h_ttft = _reg.histogram("serve.ttft_ms")
        self._g_live.set(len(self._live))

    # -- dispatch -----------------------------------------------------------
    def live_replicas(self) -> List[int]:
        return sorted(self._live)

    def _live_decode(self) -> List[int]:
        return [i for i in sorted(self._live) if i not in self._prefill_ids]

    def _live_prefill(self) -> List[int]:
        return [i for i in sorted(self._live) if i in self._prefill_ids]

    def _effective_threshold(self) -> int:
        """The prompt-length knee, scaled by decode-pool pressure: when
        the decode tier runs low on free + reclaimable blocks, shorter
        prompts go to the prefill tier too (their prefill would land on
        the pressured pools)."""
        thr = self._prompt_threshold
        dec = self._live_decode()
        if not dec:
            return thr
        frac = min((self.replicas[i].cache.free_blocks
                    + self.replicas[i].cache.reclaimable_blocks())
                   / max(1, self.replicas[i].cache.pool_blocks - 1)
                   for i in dec)
        return max(1, thr // 4) if frac <= 0.25 else thr

    def _pick_decode_for(self, req: Request, dec: List[int]) -> int:
        """Least-loaded live decode replica, with adapter affinity: for
        an adapter-tagged request, replicas holding the adapter resident
        first, then those that have it registered. Ties break by load,
        then index."""
        adapter = getattr(req, "adapter", None)
        if adapter is not None:
            def _pool(i):
                return getattr(self.replicas[i], "adapter_pool", None)
            for has in ("resident", "registered"):
                able = [i for i in dec if _pool(i) is not None
                        and getattr(_pool(i), has)(adapter)]
                if able:
                    return min(able,
                               key=lambda i: (self.replicas[i].load, i))
        return min(dec, key=lambda i: (self.replicas[i].load, i))

    def submit(self, req: Request,
               resume_tokens: Optional[List[int]] = None) -> int:
        """Route to the least-loaded live replica; returns its index.
        With the prefill tier armed, admission classifies on prompt
        length × decode-pool pressure: long inputs go to a prefill
        replica (their decode target reserved now), short ones prefill
        in place on a decode replica. With every prefill replica dead the
        tier degrades to colocated routing. Adapter-tagged requests only
        go to a prefill replica that can graft their adapter."""
        dec = self._live_decode()
        if not dec:
            raise NoLiveReplicasError(
                "no live decode-capable replica to route to")
        pre = self._live_prefill()
        if pre and getattr(req, "adapter", None) is not None:
            pre = [i for i in pre
                   if (getattr(self.replicas[i], "adapter_pool", None)
                       is not None
                       and self.replicas[i].adapter_pool.registered(
                           req.adapter))]
        if pre:
            n_in = np.asarray(req.prompt).size + len(resume_tokens or ())
            if n_in >= self._effective_threshold():
                target = min(pre, key=lambda i: (self.replicas[i].load, i))
                self.replicas[target].submit(req,
                                             resume_tokens=resume_tokens)
                # the decode target is reserved only once the prefill
                # replica accepted the request
                with self._mig_lock:
                    self._assignment[req.rid] = \
                        self._pick_decode_locked(dec)
                self._m_dispatch.inc()
                return target
        target = self._pick_decode_for(req, dec)
        self.replicas[target].submit(req, resume_tokens=resume_tokens)
        self._m_dispatch.inc()
        return target

    # -- liveness -----------------------------------------------------------
    def step(self) -> bool:
        """Step every live replica once (a completed step renews its
        lease), then sweep expired leases. True when any replica made
        progress."""
        progress = False
        completed = []
        for i in sorted(self._live):
            try:
                if self.replicas[i].step():
                    progress = True
                completed.append(i)
            except WorkerKilledError:
                # a dead replica renews nothing: the sweep evicts it by
                # its silence, as a crash would be
                pass
        # every completed step renews at the same post-round time: the
        # replicas step one after another, so a sibling's slow step must
        # not age a healthy replica's lease
        now = self._clock()
        for i in completed:
            self._beat[i] = now
        self._collect()
        self.sweep()
        if (self._migrations or self._prefill_ids) \
                and self._pump_migrations():
            progress = True
        self._autoscale()
        return progress

    def sweep(self) -> None:
        """Evict replicas silent past the lease: epoch bump, and their
        whole unfinished load re-queued on the survivors. A dead prefill
        replica's load re-classifies through ``submit``; the handoffs it
        sourced are cancelled (their runs ride the drain), while the
        migrate-out transfers it sourced go on (the payload store and the
        wire outlive the source)."""
        now = self._clock()
        expired = [i for i in sorted(self._live)
                   if (now - self._beat[i]) * 1e3 > self.lease_ms]
        for i in expired:
            self._live.discard(i)
            self._cancel_sourced_migrations(i)
            self.epoch += 1
            self._m_evict.inc()
            self._g_epoch.set(self.epoch)
            self._g_live.set(len(self._live))
            incomplete = self.replicas[i].drain_incomplete()
            get_flight_recorder().record_event(
                "serve.replica_evicted",
                {"replica": i, "epoch": self.epoch,
                 "requeued": len(incomplete)})
            record_decision("serve", "evict",
                            f"lease-expired ({self.lease_ms} ms silent)",
                            target=i, live=len(self._live))
            log.warning("serve router: replica %d lease expired (epoch -> "
                        "%d), re-queueing %d request(s)", i, self.epoch,
                        len(incomplete))
            for req, emitted in incomplete:
                if not self._live:
                    raise NoLiveReplicasError(
                        f"replica {i} died holding {len(incomplete)} "
                        "request(s) and no survivor remains")
                self.submit(req, resume_tokens=emitted)
                self._m_requeued.inc()

    # -- replica autoscaling ------------------------------------------------
    def add_replica(self, sched: Scheduler) -> int:
        """Bring a spawned replica into the routing set: epoch bump, lease
        seeded now. Returns its index."""
        self.replicas.append(sched)
        i = len(self.replicas) - 1
        if (self._migrate_preempt and hasattr(sched, "cache")
                and getattr(sched, "role", "both") != "prefill"):
            sched.migrate_out = self._migrate_out
        self._beat[i] = self._clock()
        self._live.add(i)
        self.epoch += 1
        self._g_epoch.set(self.epoch)
        self._g_live.set(len(self._live))
        log.info("serve router: replica %d admitted (epoch -> %d)", i,
                 self.epoch)
        return i

    def drain_replica(self, i: int) -> int:
        """Retire replica ``i``: take it out of the live set (epoch bump)
        and re-queue its unfinished requests on the survivors, keeping
        their committed tokens. Returns how many moved. The caller
        records the decision."""
        if i not in self._live:
            raise ValueError(f"replica {i} is not live")
        if len(self._live) <= 1:
            raise NoLiveReplicasError(
                f"cannot drain replica {i}: it is the last live replica")
        if i not in self._prefill_ids and len(self._live_decode()) <= 1:
            raise NoLiveReplicasError(
                f"cannot drain replica {i}: it is the last live "
                "decode-capable replica")
        self._live.discard(i)
        self._cancel_sourced_migrations(i)
        self.epoch += 1
        self._g_epoch.set(self.epoch)
        self._g_live.set(len(self._live))
        incomplete = self.replicas[i].drain_incomplete()
        for req, emitted in incomplete:
            self.submit(req, resume_tokens=emitted)
            self._m_requeued.inc()
        log.info("serve router: replica %d drained (epoch -> %d), %d "
                 "request(s) re-queued", i, self.epoch, len(incomplete))
        return len(incomplete)

    def _autoscale(self) -> None:
        """One policy tick: the live replicas' queue depth and the TTFT
        window since the last tick (the registry histogram is
        cumulative), then carry out the decision."""
        if self._policy is None:
            return
        depth = sum(self.replicas[i].load for i in self._live)
        snap = self._h_ttft.snapshot()
        count = int(snap.get("count", 0))
        total = float(snap.get("sum", 0.0))
        dc = count - self._ttft_mark[0]
        ds = total - self._ttft_mark[1]
        self._ttft_mark = (count, total)
        d = self._policy.observe(serve_sample(
            live=len(self._live), queue_depth=depth,
            ttft_p99_ms=ds / dc if dc > 0 else 0.0,
            ttft_slo_ms=self._ttft_slo_ms))
        if d.action == "admit":
            self.add_replica(self._spawn())
        elif d.action == "evict":
            # drain the least-loaded live decode replica (the prefill
            # tier is not the policy's to shrink); ties to the newest
            dec = self._live_decode()
            if len(dec) > 1:
                self.drain_replica(min(sorted(dec, reverse=True),
                                       key=lambda i: self.replicas[i].load))

    # -- KV migration plane -------------------------------------------------
    @staticmethod
    def _codec_key(sched: Scheduler):
        st = sched.cache.state
        return (sched.cache.block_size, sched.cache.quant,
                st.k.shape[0], tuple(st.k.shape[2:]), str(st.k.dtype))

    def _wire_for(self, i: int):
        """Source replica ``i``'s outbound migration NIC, built on first
        use (a colocated router never builds one)."""
        w = self._wires.get(i)
        if w is None:
            from byteps_tpu_torch.serve.kv_wire import KVWire

            resolve = self._resolve_target
            if self._kv_target_wrap is not None:
                # wrap ONLY the wire's delivery surface: the adoption
                # bookkeeping elsewhere still needs the local object
                wrap = self._kv_target_wrap

                def resolve(rid, _r=self._resolve_target, _w=wrap):
                    t = _r(rid)
                    return None if t is None else _w(t)

            w = KVWire(self.replicas[i].kv_codec, resolve,
                       mbps=self._wire_mbps, credit=self._wire_credit)
            self._wires[i] = w
        return w

    def _pick_decode_locked(self, dec: List[int]) -> int:
        """Least-loaded live decode replica, counting pending migration
        assignments as load (a replica's ``load`` moves only at
        adoption). Callers hold ``_mig_lock``."""
        pending: Dict[int, int] = {}
        for t in self._assignment.values():
            pending[t] = pending.get(t, 0) + 1
        return min(dec, key=lambda i: (self.replicas[i].load
                                       + pending.get(i, 0), i))

    def _resolve_target(self, rid):
        """The current decode target of a migrating rid, called by the
        KVWire push threads on every delivery attempt: a dead target is
        remapped to a live sibling. None when no decode replica lives (the
        push retries; the payload store re-sends either way), and for a
        rid with no active migration or stream (a straggler push whose
        migration was cancelled, or whose request completed, dies quietly
        instead of staging orphan payloads)."""
        with self._mig_lock:
            t = self._assignment.get(rid)
            if t is not None and t in self._live \
                    and t not in self._prefill_ids:
                return self.replicas[t]
            if (t is None and rid not in self._migrations
                    and rid not in self._stream_src):
                return None
            dec = self._live_decode()
            if not dec:
                return None
            nt = self._pick_decode_locked(dec)
            if t is not None:
                self._m_mig_retarget.inc()
                get_flight_recorder().record_event(
                    "serve.migration.retarget",
                    {"rid": str(rid), "from": t, "to": nt})
            self._assignment[rid] = nt
            return self.replicas[nt]

    def _make_stream_cb(self, i: int):
        """Prefill replica ``i``'s block-commit hook: each newly full
        block goes onto the wire now (overlapping the next chunk) and
        into the payload store (the retransmit source until adoption)."""
        def cb(sched, run, payloads):
            rid = run.req.rid
            wire = self._wire_for(i)
            store = self._stream_store.setdefault(rid, {})
            handles = self._stream_handles.setdefault(rid, {})
            self._stream_src[rid] = i
            for bi, p in payloads.items():
                store[bi] = p
                handles[bi] = wire.send_block(rid, bi, p)
        return cb

    def _migrate_out(self, sched: Scheduler, run) -> bool:
        """Migrate-don't-evict: ``sched`` is about to preempt ``run`` —
        move its committed blocks to the roomiest live sibling that can
        hold them instead. False (the eviction proceeds) when none can."""
        src = self.replicas.index(sched)
        need = sched.cache.blocks_for(run.cache_len + 1)
        with self._mig_lock:
            sibs = [i for i in self._live_decode()
                    if i != src and self.replicas[i].cache.free_blocks
                    + self.replicas[i].cache.reclaimable_blocks() >= need]
            if not sibs:
                return False
            target = max(sibs,
                         key=lambda i: self.replicas[i].cache.free_blocks
                         - self.replicas[i].load)
            rid = run.req.rid
            self._assignment[rid] = target
        ticket = sched.extract_for_migration(rid)
        wire = self._wire_for(src)
        handles = {bi: wire.send_block(rid, bi, p)
                   for bi, p in ticket.payloads.items()}
        self._migrations[rid] = {
            "ticket": ticket, "source": src, "src_holds": False,
            "payloads": dict(ticket.payloads), "handles": handles}
        get_flight_recorder().record_event(
            "serve.migration.start",
            {"rid": str(rid), "kind": "preempt", "from": src,
             "to": target, "blocks": ticket.n_blocks})
        return True

    def _begin_handoff(self, src: int, ticket) -> None:
        rid = ticket.req.rid
        payloads = self._stream_store.pop(rid, {})
        payloads.update(ticket.payloads)
        handles = self._stream_handles.pop(rid, {})
        self._stream_src.pop(rid, None)
        wire = self._wire_for(src)
        for bi, p in ticket.payloads.items():
            handles[bi] = wire.send_block(rid, bi, p)
        self._migrations[rid] = {
            "ticket": ticket, "source": src, "src_holds": True,
            "payloads": payloads, "handles": handles}
        get_flight_recorder().record_event(
            "serve.migration.start",
            {"rid": str(rid), "kind": "handoff", "from": src,
             "blocks": ticket.n_blocks})

    def _cancel_sourced_migrations(self, i: int) -> None:
        """Source replica ``i`` left the live set: its handoffs and
        mid-prefill streams cancel (their runs ride its drain and
        recompute), while its migrate-out transfers go on (their blocks
        were extracted already)."""
        gone = [r for r, m in self._migrations.items()
                if m["source"] == i and m["src_holds"]]
        gone += [r for r, s in self._stream_src.items()
                 if s == i and r not in gone]
        for rid in gone:
            self._migrations.pop(rid, None)
            self._stream_store.pop(rid, None)
            self._stream_handles.pop(rid, None)
            self._stream_src.pop(rid, None)
            with self._mig_lock:
                t = self._assignment.pop(rid, None)
            if t is not None and t < len(self.replicas):
                self.replicas[t].drop_staged(rid)

    def _pump_migrations(self) -> bool:
        """One migration tick: collect new prefill handoffs, then push
        every pending migration on (re-send what failed or landed on a
        target that died since; adopt once the target staged every
        block). True when anything moved."""
        progress = False
        for i in self._live_prefill():
            for ticket in self.replicas[i].pop_handoffs():
                self._begin_handoff(i, ticket)
                progress = True
        for rid in list(self._migrations):
            if self._advance_migration(rid):
                progress = True
        return progress

    def _advance_migration(self, rid) -> bool:
        m = self._migrations[rid]
        ticket = m["ticket"]
        target = self._resolve_target(rid)
        if target is None:
            return False          # no decode tier right now; keep waiting
        wire = self._wire_for(m["source"])
        waiting = False
        for bi in range(ticket.n_blocks):
            h = m["handles"].get(bi)
            if h is not None and h.failed():
                cause = getattr(h.error(), "cause", None)
                if cause is not None and not getattr(cause, "retryable",
                                                     True):
                    # a layout mismatch: re-sending cannot fix it
                    raise RuntimeError(
                        f"KV migration for {rid!r} failed terminally: "
                        f"{cause}") from cause
                # the retries are spent (every attempt hit a dead target
                # before the remap): re-send from the payload store
                wire.abandon(1)
                h = None
            if h is None:
                m["handles"][bi] = wire.send_block(rid, bi,
                                                   m["payloads"][bi])
                waiting = True
            elif not h.done():
                waiting = True
        if waiting:
            return False
        staged = target.staged_blocks(rid)
        missing = [bi for bi in range(ticket.n_blocks) if bi not in staged]
        if missing:
            # delivered to a target that died before adoption: re-send
            # to the current one
            for bi in missing:
                m["handles"][bi] = wire.send_block(rid, bi,
                                                   m["payloads"][bi])
            return True
        if target.submit_migrated(ticket, target.pop_staged(rid)):
            self._m_mig_done.inc()
            if m["src_holds"]:
                self.replicas[m["source"]].finish_handoff(rid)
            get_flight_recorder().record_event(
                "serve.migration.adopted",
                {"rid": str(rid), "blocks": ticket.n_blocks})
        else:
            # the target cannot hold it even after preemption: recompute
            # on resume — slower, never wrong
            self._m_mig_fallback.inc()
            get_flight_recorder().record_event(
                "serve.migration.fallback",
                {"rid": str(rid), "blocks": ticket.n_blocks})
            if m["src_holds"]:
                self.replicas[m["source"]].finish_handoff(rid)
            target.submit(ticket.req, resume_tokens=ticket.emitted)
        del self._migrations[rid]
        with self._mig_lock:
            self._assignment.pop(rid, None)
        return True

    def close(self) -> None:
        """Shut the migration wires down (their stage pools own threads);
        idempotent."""
        for w in self._wires.values():
            w.shutdown()
        self._wires.clear()

    def _collect(self) -> None:
        """Move newly completed results up to the router, stamped with
        the epoch and the replica they completed under."""
        for i, sched in enumerate(self.replicas):
            while sched.results:
                rid, res = sched.results.popitem()
                res = dict(res)
                res["epoch"] = self.epoch
                res["replica"] = i
                self.results[rid] = res
                if self._prefill_ids or self._migrations:
                    # a cancelled or retargeted migration can strand
                    # staged payloads of this rid: reclaim them
                    with self._mig_lock:
                        self._assignment.pop(rid, None)
                    for other in self.replicas:
                        other.drop_staged(rid)

    # -- convenience --------------------------------------------------------
    def finished(self, rids) -> bool:
        return all(r in self.results for r in rids)

    def run(self, requests: List[Request],
            max_idle_iters: int = 10000) -> Dict[Any, Dict[str, Any]]:
        """Dispatch ``requests`` in arrival order (each at its
        ``arrival_s``) and drive the replicas until every one completed.
        An idle step sleeps (at most 50 ms, a twentieth of the lease) so
        a dead replica's silence can reach its lease; the loop gives up
        only after ``max_idle_iters`` idle steps and twice the lease of
        idle wall time."""
        pending = sorted(requests, key=lambda r: r.arrival_s)
        rids = [r.rid for r in requests]
        idle = 0
        idle_since = None
        while not self.finished(rids):
            now = self._clock()
            while pending and pending[0].arrival_s <= now:
                self.submit(pending.pop(0))
            if self.step():
                idle = 0
                idle_since = None
                continue
            idle += 1
            if idle_since is None:
                idle_since = self._clock()
            time.sleep(min(0.05, max(1e-4, self.lease_ms / 20e3)))
            if (idle > max_idle_iters
                    and (self._clock() - idle_since) * 1e3
                    > 2 * self.lease_ms):
                raise RuntimeError(
                    "router made no progress with "
                    f"{len(rids) - len(self.results)} request(s) "
                    "outstanding")
        return self.results
