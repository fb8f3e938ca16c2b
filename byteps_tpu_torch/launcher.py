"""bpslaunch for the port — role dispatch, local process spawn, and the
supervisor of real worker processes (the port's counterpart of
``byteps_tpu/launcher.py``).

Reference analog: ``launcher/launch.py`` (installed as ``bpslaunch``):
reads ``DMLC_ROLE``; the server role runs the summation service
(``byteps_tpu_torch.server.serve_forever``); the worker role spawns
``BYTEPS_LOCAL_SIZE`` copies of the user command with per-child rank env,
monitors them, and tears the job down if any child fails.

As in ``byteps_tpu``, there is no separate scheduler node — rendezvous is
the global ``torch.distributed`` group (``comm/distributed.py``) or
direct worker→server TCP connects with retry. ``DMLC_ROLE=scheduler`` is
accepted for reference-script compatibility and idles until killed.
With ``BYTEPS_JAX_DISTRIBUTED=1`` the worker role interposes
``byteps_tpu_torch._boot``, which forms the group before the script runs.

:class:`Supervisor` runs worker processes under the elastic control
plane, and ``--child-worker`` is the supervised worker driver (the
``BYTEPS_CHILD_*`` contract in :func:`_child_worker_main`). Importing
this module imports no torch, and the child driver touches no card.

Usage (same shape as the reference):
    DMLC_ROLE=server DMLC_NUM_WORKER=2 ... python -m byteps_tpu_torch.launcher
    DMLC_ROLE=worker DMLC_WORKER_ID=0 ... python -m byteps_tpu_torch.launcher \
        python train.py
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

from byteps_tpu_torch.common.config import get_config
from byteps_tpu_torch.common.logging import get_logger

log = get_logger("launcher")


def _run_server() -> int:
    from byteps_tpu_torch.server import serve_forever

    serve_forever()
    return 0


def _run_scheduler() -> int:
    # Compatibility shim: there is no scheduler node (the global
    # torch.distributed group replaces ps-lite rendezvous). Block until
    # SIGTERM so launch scripts that expect a long-lived scheduler work.
    log.info("scheduler role is a no-op in byteps_tpu_torch; idling until "
             "killed")
    signal.sigwait({signal.SIGTERM, signal.SIGINT})
    return 0


def _wrap_global_group(cmd: List[str]) -> List[str]:
    """Interpose the group bootstrap (``byteps_tpu_torch._boot``) around a
    python command so the global ``torch.distributed`` group forms BEFORE
    user code runs (reference: ps-lite rendezvous precedes all CUDA work
    in byteps_init). Interpreter flags (``python -u train.py``) are kept
    ahead of the ``-m`` interposition. Commands that cannot be wrapped
    (non-python binaries, ``python -m pkg``, ``python -c ...``) run
    unwrapped with a warning — the script must then join the group
    itself (``comm.distributed.maybe_init_distributed``)."""
    exe = os.path.basename(cmd[0])
    if exe.startswith("python"):
        for i, arg in enumerate(cmd[1:], start=1):
            if arg in ("-m", "-c"):
                break  # module/inline form: runpy.run_path can't replay it
            if not arg.startswith("-"):
                return (cmd[:i] + ["-m", "byteps_tpu_torch._boot"]
                        + cmd[i:])
    log.warning(
        "cannot interpose the torch.distributed bootstrap around %r; the "
        "script must join the global group itself "
        "(comm.distributed.maybe_init_distributed)", " ".join(cmd),
    )
    return cmd


def _spawn_workers(cmd: List[str]) -> int:
    cfg = get_config()
    local_size = cfg.local_size
    procs: List[subprocess.Popen] = []
    single_host_sim = (
        local_size > 1 and cfg.num_worker == local_size and cfg.worker_id == 0
    )
    if cfg.global_group:
        cmd = _wrap_global_group(cmd)
    for i in range(local_size):
        env = dict(os.environ)
        env["BYTEPS_LOCAL_RANK"] = str(i)
        env["BYTEPS_LOCAL_SIZE"] = str(local_size)
        if single_host_sim:
            # localhost multi-worker simulation (reference test pattern:
            # N worker processes on one machine, each a full DMLC worker)
            env["DMLC_WORKER_ID"] = str(i)
        log.info("spawning worker local_rank=%d: %s", i, " ".join(cmd))
        procs.append(subprocess.Popen(cmd, env=env))
    rc = 0
    try:
        # fail-fast: first nonzero child exit kills the rest (reference
        # launch.py child monitoring)
        remaining = set(range(len(procs)))
        while remaining:
            for idx in list(remaining):
                p = procs[idx]
                try:
                    r = p.wait(timeout=0.2)
                except subprocess.TimeoutExpired:
                    continue
                remaining.discard(idx)
                if r != 0:
                    log.error("worker local_rank=%d exited rc=%d — "
                              "terminating job", idx, r)
                    rc = r
                    for j in remaining:
                        procs[j].terminate()
                    for j in remaining:
                        try:
                            procs[j].wait(timeout=10)
                        except subprocess.TimeoutExpired:
                            procs[j].kill()
                    remaining.clear()
                    # stop scanning this snapshot: the siblings we just
                    # SIGTERMed would otherwise report rc=-15 and
                    # overwrite the REAL failure's rc
                    break
    except KeyboardInterrupt:
        for p in procs:
            p.terminate()
        rc = 130
    return rc


# --------------------------------------------------------------------------
# Supervisor: real OS-process membership under the elastic control plane
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Child:
    """One supervised worker process and its restart bookkeeping."""

    wid: int
    proc: subprocess.Popen
    argv: List[str]
    env: Dict[str, str]
    plan: Any = None              # proc-scoped FaultPlan, or None
    auto_restart: bool = False
    restarts: int = 0
    retired: bool = False
    term_deadline: Optional[float] = None
    # armed by a proc:restart fault or a crash with restart budget left
    backoff_until: Optional[float] = None


class Supervisor:
    """Spawn/retire REAL worker processes off autoscaler decisions.

    The launcher grown into a supervisor, so the lease/epoch machinery
    runs against processes that actually die:

    * :meth:`execute` maps a :class:`~byteps_tpu_torch.common.autoscaler.
      Decision` to the real world: ``admit`` spawns a child that joins
      mid-stream via the kJoin protocol (``BYTEPS_CHILD_JOIN=1`` →
      ``PSWorker.join()``), ``evict`` retires one (SIGTERM → the child
      exits WITHOUT the shutdown goodbye → the server lease-evicts its
      id and bumps the epoch — scale-down IS the eviction path, as in
      the in-process churn harness). Both land on the shared
      ``autoscaler.decision`` event path (``domain="proc"``).
    * :meth:`poll` is the supervision tick: it ticks each child's
      ``proc:``-scoped :class:`~byteps_tpu_torch.common.faults.FaultPlan`
      (``proc:kill@step=N`` → REAL ``SIGKILL``, ``proc:restart@p=...``
      → SIGKILL + respawn), reaps exits with STRUCTURED reasons
      (``clean`` / ``error:rc=N`` / ``signal:SIGKILL``) into the
      flight recorder + registry, escalates overdue retires
      (SIGTERM → grace → SIGKILL), and executes bounded
      restart-with-backoff for flapping children (delay doubles per
      consecutive restart; past ``restart_limit`` the child is given
      up with a ``supervisor.giveup`` event instead of a hot loop).
    * Crash-resume: a respawned child carries
      ``BYTEPS_SUPERVISOR_RESTARTS`` so the driver knows to
      ``rejoin()`` + restore from its ``Checkpointer`` directory
      (``BYTEPS_CHILD_CKPT``) before continuing the round sequence.

    The default child command is this module's own ``--child-worker``
    driver; tests/benches override ``argv``/``base_env`` to run any
    program. The supervisor is single-threaded by design — callers own
    the poll cadence (``cfg.supervisor_poll_ms`` between ticks), so
    chaos tests can single-step it deterministically.
    """

    def __init__(self, *, argv: Optional[List[str]] = None,
                 base_env: Optional[Dict[str, str]] = None,
                 restart_limit: Optional[int] = None,
                 backoff_ms: Optional[int] = None,
                 grace_ms: Optional[int] = None,
                 fault_spec: str = "", fault_seed: int = 0,
                 first_wid: int = 0):
        from byteps_tpu_torch.common.faults import parse_fault_spec
        from byteps_tpu_torch.common.metrics import get_registry

        cfg = get_config()
        self._argv = list(argv) if argv else [
            sys.executable, "-m", "byteps_tpu_torch.launcher",
            "--child-worker"]
        self._base_env = dict(base_env or {})
        self.restart_limit = (restart_limit if restart_limit is not None
                              else cfg.supervisor_restart_limit)
        self._backoff_s = (backoff_ms if backoff_ms is not None
                           else cfg.supervisor_backoff_ms) / 1e3
        self._grace_s = (grace_ms if grace_ms is not None
                         else cfg.supervisor_grace_ms) / 1e3
        # proc:-scoped rules only: the supervision tick must never
        # consume (or fire) a child's own wire-weather rules — those
        # belong to the child process's in-process plan
        self._fault_rules = [r for r in parse_fault_spec(fault_spec)
                             if r.scope == "proc"]
        self._fault_seed = fault_seed
        self._children: Dict[int, _Child] = {}
        self._next_wid = first_wid
        self.exit_reasons: Dict[int, List[str]] = {}
        _reg = get_registry()
        self._m_spawns = _reg.counter("supervisor.spawns")
        self._m_exits = _reg.counter("supervisor.exits")
        self._m_exit_kind = {
            k: _reg.counter(f"supervisor.exit.{k}")
            for k in ("clean", "error", "signal")}
        self._m_restarts = _reg.counter("supervisor.restarts")
        self._m_giveups = _reg.counter("supervisor.giveups")
        self._m_retired = _reg.counter("supervisor.retired")

    # -- membership views ---------------------------------------------------
    def live(self) -> List[int]:
        """wids with a running (or backoff-pending) process."""
        return sorted(self._children)

    def child(self, wid: int) -> Optional[subprocess.Popen]:
        c = self._children.get(wid)
        return c.proc if c is not None else None

    # -- spawn / retire / kill ----------------------------------------------
    def _plan_for(self, wid: int):
        from byteps_tpu_torch.common.faults import FaultPlan

        if not self._fault_rules:
            return None
        return FaultPlan(self._fault_rules, seed=self._fault_seed,
                         worker_id=wid)

    def spawn(self, wid: Optional[int] = None,
              extra_env: Optional[Dict[str, str]] = None,
              argv: Optional[List[str]] = None,
              auto_restart: bool = False,
              _restarts: int = 0,
              _env: Optional[Dict[str, str]] = None) -> int:
        """Start one child worker process; returns its wid."""
        from byteps_tpu_torch.common.flight_recorder import get_flight_recorder

        if wid is None:
            wid = self._next_wid
        if wid in self._children:
            raise ValueError(f"worker {wid} is already supervised")
        self._next_wid = max(self._next_wid, wid + 1)
        cmd = list(argv) if argv else list(self._argv)
        if _env is not None:
            env = dict(_env)  # respawn: the dead child's env, verbatim
        else:
            env = dict(os.environ)
            env.update(self._base_env)
            env.update(extra_env or {})
            env["DMLC_WORKER_ID"] = str(wid)
        env["BYTEPS_SUPERVISOR_RESTARTS"] = str(_restarts)
        proc = subprocess.Popen(cmd, env=env)
        self._children[wid] = _Child(
            wid=wid, proc=proc, argv=cmd, env=env,
            plan=self._plan_for(wid), auto_restart=auto_restart,
            restarts=_restarts)
        self._m_spawns.inc()
        get_flight_recorder().record_event(
            "supervisor.spawn",
            {"wid": wid, "pid": proc.pid, "restarts": _restarts})
        log.info("supervisor: spawned worker %d (pid=%d, restarts=%d)",
                 wid, proc.pid, _restarts)
        return wid

    def kill(self, wid: int, sig: int = signal.SIGKILL) -> None:
        """REAL signal to a live child (the chaos tier's process-death
        instrument — no emulation, the PID dies)."""
        c = self._children.get(wid)
        if c is None or c.backoff_until is not None:
            return
        try:
            c.proc.send_signal(sig)
        except (ProcessLookupError, OSError):
            pass

    def retire(self, wid: int) -> None:
        """Graceful scale-down: SIGTERM; the child driver exits 0
        WITHOUT the shutdown goodbye, so the server lease-evicts the id
        (epoch bump) exactly like the in-process churn harness. A child
        that ignores the grace window is SIGKILLed by :meth:`poll`."""
        c = self._children.get(wid)
        if c is None:
            return
        c.retired = True
        c.auto_restart = False
        c.term_deadline = time.monotonic() + self._grace_s
        self._m_retired.inc()
        try:
            c.proc.terminate()
        except (ProcessLookupError, OSError):
            pass

    def execute(self, decision,
                spawn_env: Optional[Dict[str, str]] = None
                ) -> Optional[int]:
        """Carry out one ScalingPolicy decision against real processes;
        returns the wid acted on (None for hold). The DECISION was
        already recorded by the policy's ``observe`` (the shared
        ``autoscaler.decision`` path); what lands here is the
        EXECUTION — which pid-owning wid the decision bound to."""
        from byteps_tpu_torch.common.flight_recorder import get_flight_recorder

        wid: Optional[int] = None
        if decision.action == "admit":
            env = {"BYTEPS_CHILD_JOIN": "1"}
            env.update(spawn_env or {})
            wid = self.spawn(extra_env=env)
        elif decision.action == "evict":
            live = self.live()
            if not live:
                return None
            wid = live[-1]
            self.retire(wid)
        if wid is not None:
            get_flight_recorder().record_event(
                "supervisor.execute",
                {"action": decision.action, "reason": decision.reason,
                 "wid": wid, "live": len(self._children)})
        return wid

    # -- supervision tick ---------------------------------------------------
    @staticmethod
    def _classify(rc: int) -> str:
        if rc == 0:
            return "clean"
        if rc < 0:
            try:
                name = signal.Signals(-rc).name
            except ValueError:
                name = str(-rc)
            return f"signal:{name}"
        return f"error:rc={rc}"

    def poll(self) -> List[Dict[str, Any]]:
        """One supervision tick: proc-fault plans → real signals, reap
        exits (structured reasons), escalate overdue retires, respawn
        backoff-expired children. Returns this tick's exit records."""
        from byteps_tpu_torch.common.flight_recorder import get_flight_recorder

        now = time.monotonic()
        rec = get_flight_recorder()
        exits: List[Dict[str, Any]] = []
        for wid, c in list(self._children.items()):
            if c.backoff_until is not None:
                # respawn once the (doubling) backoff elapsed
                if now >= c.backoff_until:
                    del self._children[wid]
                    self._m_restarts.inc()
                    rec.record_event("supervisor.restart",
                                     {"wid": wid,
                                      "restarts": c.restarts + 1})
                    self.spawn(wid, argv=c.argv,
                               auto_restart=c.auto_restart,
                               _restarts=c.restarts + 1, _env=c.env)
                continue
            if c.proc.poll() is None:
                # alive: tick its proc:-scoped plan — injections become
                # REAL signals, one plan step per poll per child
                inj = (c.plan.intercept("proc", -1)
                       if c.plan is not None else None)
                if inj is not None and inj.kind in ("kill", "restart"):
                    if inj.kind == "restart":
                        c.auto_restart = True
                    self.kill(wid)
                elif c.term_deadline is not None \
                        and now >= c.term_deadline:
                    log.warning("supervisor: worker %d ignored SIGTERM "
                                "for %.1fs — escalating to SIGKILL",
                                wid, self._grace_s)
                    self.kill(wid)
                continue
            # exited: classify, record, maybe respawn
            rc = c.proc.returncode
            reason = self._classify(rc)
            self._m_exits.inc()
            self._m_exit_kind[reason.split(":", 1)[0]].inc()
            self.exit_reasons.setdefault(wid, []).append(reason)
            rec.record_event("supervisor.exit",
                             {"wid": wid, "pid": c.proc.pid, "rc": rc,
                              "reason": reason, "retired": c.retired,
                              "restarts": c.restarts})
            log.info("supervisor: worker %d exited (%s)", wid, reason)
            exits.append({"wid": wid, "rc": rc, "reason": reason,
                          "retired": c.retired, "restarts": c.restarts})
            if c.auto_restart and not c.retired and reason != "clean":
                if c.restarts >= self.restart_limit:
                    self._m_giveups.inc()
                    rec.record_event("supervisor.giveup",
                                     {"wid": wid,
                                      "restarts": c.restarts})
                    log.error("supervisor: worker %d flapped past the "
                              "restart limit (%d) — giving up",
                              wid, self.restart_limit)
                    del self._children[wid]
                else:
                    c.backoff_until = (now + self._backoff_s
                                       * (2 ** c.restarts))
            else:
                del self._children[wid]
        return exits

    def wait_all(self, timeout_s: float = 60.0,
                 poll_ms: Optional[int] = None) -> bool:
        """Poll until every supervised child is gone; False on timeout
        (children are still the caller's to shut down)."""
        step = (poll_ms if poll_ms is not None
                else get_config().supervisor_poll_ms) / 1e3
        deadline = time.monotonic() + timeout_s
        while self._children:
            self.poll()
            if not self._children:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(step)
        return True

    def shutdown(self) -> None:
        """Terminate everything, escalating to SIGKILL after grace —
        the teardown path MUST leak zero child processes."""
        for c in self._children.values():
            c.auto_restart = False
            if c.backoff_until is None:
                try:
                    c.proc.terminate()
                except (ProcessLookupError, OSError):
                    pass
        deadline = time.monotonic() + self._grace_s
        for c in self._children.values():
            if c.backoff_until is not None:
                continue
            try:
                c.proc.wait(timeout=max(0.0,
                                        deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                c.proc.kill()
                c.proc.wait(timeout=10)
        self._children.clear()


# --------------------------------------------------------------------------
# --child-worker: the supervised worker process driver
# --------------------------------------------------------------------------


def _child_worker_main() -> int:
    """Supervised worker child: deterministic push/pull rounds (or an
    idle heartbeat) against the server tier, env-driven so the
    supervisor/bench/tests compose behaviors without a zoo of helper
    scripts:

    ``BYTEPS_CHILD_SERVERS``   host:port[,host:port...] (required)
    ``BYTEPS_CHILD_ROUNDS``    N push/pull rounds; 0 = idle heartbeat
                               until SIGTERM (scale-up probe child)
    ``BYTEPS_CHILD_JOIN``      1 = kJoin admission before the loop
    ``BYTEPS_CHILD_PIN``       1 = pin version r+1 on round r's push so
                               a crash-resume redo replay-dedupes
    ``BYTEPS_CHILD_CKPT``      Checkpointer dir: save state per round,
                               restore + rejoin on restart
    ``BYTEPS_CHILD_OUT``       final JSON path; per-round progress
                               lines stream to ``<out>.progress``
    ``BYTEPS_CHILD_ELEMS/SEED/KEY/ROUND_DELAY_MS`` shape the rounds.

    Round r's payload is ``default_rng((seed, wid, r))`` — recomputable
    after a crash, so bit-identity across death is assertable from the
    outside. SIGTERM means RETIRE: exit 0 WITHOUT the shutdown goodbye
    (the server lease-evicts this id); a completed round loop does say
    goodbye (``PSWorker.shutdown``) so the server can exit with the
    job."""
    import json
    import zlib

    import numpy as np

    from byteps_tpu_torch.server import PSWorker

    wid = int(os.environ.get("DMLC_WORKER_ID", "0"))
    servers_env = os.environ.get("BYTEPS_CHILD_SERVERS", "")
    if not servers_env:
        log.error("--child-worker needs BYTEPS_CHILD_SERVERS=host:port")
        return 2
    servers = []
    for part in servers_env.split(","):
        host, _, port = part.strip().rpartition(":")
        servers.append((host or "127.0.0.1", int(port)))
    rounds = int(os.environ.get("BYTEPS_CHILD_ROUNDS", "0"))
    elems = int(os.environ.get("BYTEPS_CHILD_ELEMS", "256"))
    seed = int(os.environ.get("BYTEPS_CHILD_SEED", "1234"))
    key = int(os.environ.get("BYTEPS_CHILD_KEY", "7"))
    out_path = os.environ.get("BYTEPS_CHILD_OUT", "")
    do_join = os.environ.get("BYTEPS_CHILD_JOIN", "0") == "1"
    pin = os.environ.get("BYTEPS_CHILD_PIN", "0") == "1"
    ckpt_dir = os.environ.get("BYTEPS_CHILD_CKPT", "")
    delay_s = int(os.environ.get("BYTEPS_CHILD_ROUND_DELAY_MS",
                                 "0")) / 1e3
    restarts = int(os.environ.get("BYTEPS_SUPERVISOR_RESTARTS", "0"))

    stop = {"term": False}

    def _on_term(signum, frame):  # noqa: ARG001 - signal signature
        stop["term"] = True

    signal.signal(signal.SIGTERM, _on_term)

    w = PSWorker(servers=servers, worker_id=wid)
    ck = state = None
    start_round = 0
    if ckpt_dir:
        from byteps_tpu_torch.checkpoint import Checkpointer

        ck = Checkpointer(ckpt_dir, max_to_keep=2, async_save=False)
        state = np.zeros(elems, np.float32)
        last = ck.latest_step()
        if last is not None:
            restored = ck.restore(
                {"state": state, "round": 0}, step=last)
            state = np.asarray(restored["state"], np.float32)
            start_round = int(restored["round"]) + 1
            log.info("child %d: resuming from checkpoint round %d",
                     wid, start_round - 1)
    if restarts > 0 or (ckpt_dir and start_round > 0):
        # crash-resume: re-admit the id + adopt the server's round
        # watermarks BEFORE minting anything
        w.rejoin()
    elif do_join:
        w.join()

    results: List[List[int]] = []
    progress = open(out_path + ".progress", "a",
                    buffering=1) if out_path else None
    try:
        if rounds <= 0:
            # idle probe: hold the lease by pinging until retired
            while not stop["term"]:
                for sidx in range(len(servers)):
                    try:
                        w.ping(sidx)
                    except Exception:  # noqa: BLE001 - probe only
                        pass
                time.sleep(0.1)
            return 0  # retire: NO goodbye → lease eviction
        w.init_key(key, elems * 4)
        for r in range(start_round, rounds):
            if stop["term"]:
                return 0  # retired mid-run: same no-goodbye contract
            data = np.random.default_rng(
                (seed, wid, r)).standard_normal(elems).astype(np.float32)
            buf = data.view(np.uint8)
            v = w.push_bytes(key, buf,
                             version=(r + 1) if pin else None)
            out = w.pull_bytes(key, buf.nbytes, v)
            crc = zlib.crc32(out.tobytes()) & 0xFFFFFFFF
            results.append([r, int(v), int(crc)])
            if progress is not None:
                progress.write(f"{r} {v} {crc}\n")
            if ck is not None:
                state = state + out.view(np.float32)
                ck.save(r, {"state": state, "round": r}, force=True)
            if delay_s:
                time.sleep(delay_s)
        w.shutdown()  # completed: goodbye so the server can exit
        if out_path:
            final: Dict[str, Any] = {
                "wid": wid, "rounds": results, "restarts": restarts,
                "resumed_from": start_round,
                "counters": dict(w.counters),
            }
            if state is not None:
                final["state_crc"] = int(
                    zlib.crc32(state.tobytes()) & 0xFFFFFFFF)
                final["state_sum"] = float(state.sum())
            with open(out_path, "w") as f:
                json.dump(final, f)
        return 0
    finally:
        if progress is not None:
            progress.close()


_USAGE = """\
bpslaunch — the byteps_tpu_torch job launcher (reference: launcher/launch.py)

Usage:
  DMLC_ROLE=server  DMLC_NUM_WORKER=N ... python -m byteps_tpu_torch.launcher
  DMLC_ROLE=worker  DMLC_WORKER_ID=i ... python -m byteps_tpu_torch.launcher \\
      python train.py [args...]

Role comes from DMLC_ROLE (worker | server | scheduler | joint). The worker
role spawns BYTEPS_LOCAL_SIZE copies of the given command with per-child
rank env and tears the job down if any child fails; with
BYTEPS_JAX_DISTRIBUTED=1 it also interposes the torch.distributed bootstrap
(byteps_tpu_torch._boot) so one gloo group spans all workers.

--child-worker runs the SUPERVISED worker driver (spawned by the
Supervisor class; see its docstring for the BYTEPS_CHILD_* contract).
"""


def main(argv: List[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-h", "--help"):
        print(_USAGE)
        return 0
    if argv and argv[0] == "--child-worker":
        return _child_worker_main()
    cfg = get_config()
    role = cfg.role.lower()
    if role == "server":
        return _run_server()
    if role == "scheduler":
        return _run_scheduler()
    if role in ("worker", "joint"):
        if not argv:
            log.error("worker role needs a command to run")
            return 2
        return _spawn_workers(argv)
    log.error("unknown DMLC_ROLE=%r", role)
    return 2


if __name__ == "__main__":
    sys.exit(main())
