"""The port's launcher supervisor (``byteps_tpu_torch/launcher.py``),
twin of ``tests/test_supervisor.py``: real OS processes under the
elastic control plane — structured exit reasons, ``proc:`` fault plans
as real signals, bounded restart with backoff, policy admit (kJoin) and
evict (lease eviction) against a port server, and crash-resume through
the port's ``Checkpointer`` — plus the ``--child-worker`` driver held
against the reference's: the same ``BYTEPS_CHILD_*`` environment against
each package's own server ends on the same ``state_crc`` and per-round
CRCs.

Every wait on a process or a socket here is bounded by its own limit
(``_T`` a wait, subprocess timeouts): a hung child fails its test.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from byteps_tpu_torch import metrics_snapshot
from byteps_tpu_torch.common import config as config_mod
from byteps_tpu_torch.common.autoscaler import Sample, ScalingPolicy
from byteps_tpu_torch.common.faults import (
    FaultPlan,
    parse_fault_spec,
    rules_to_spec,
)
from byteps_tpu_torch.common.flight_recorder import (
    get_flight_recorder,
    reset_flight_recorder,
)
from byteps_tpu_torch.common.metrics import get_registry, reset_registry
from byteps_tpu_torch.launcher import Supervisor
from byteps_tpu_torch.server import PSWorker, start_server, stop_server

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from dcn_fixtures import next_port, port_lib  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_T = 60  # hard cap (s) on any single wait in this module


@pytest.fixture(autouse=True)
def _fresh():
    reset_registry()
    reset_flight_recorder()
    yield
    stop_server()
    config_mod.reset_config()


def _counters():
    return get_registry().snapshot()["counters"]


def _child_argv(code: str):
    return [sys.executable, "-c", code]


# ---- proc: fault grammar ----------------------------------------------------
def test_proc_grammar_round_trips():
    spec = "proc:kill@step=3;proc1:restart@p=0.5"
    rules = parse_fault_spec(spec)
    assert [(r.scope, r.kind, r.worker) for r in rules] == [
        ("proc", "kill", None), ("proc", "restart", 1)]
    assert parse_fault_spec(rules_to_spec(rules)) == rules


@pytest.mark.parametrize("bad,hint", [
    ("proc:timeout@op=1", "kill|restart"),
    ("proc:corrupt@p=0.1", "kill|restart"),
    ("worker:restart@p=0.1", "supervisor action"),
    ("replica1:restart", "supervisor action"),
    ("procx:kill", "bad proc index"),
])
def test_proc_grammar_structured_errors(bad, hint):
    with pytest.raises(ValueError) as ei:
        parse_fault_spec(bad)
    msg = str(ei.value)
    assert msg.startswith("bad BYTEPS_FAULT_SPEC rule")
    assert hint in msg
    assert "invalid literal" not in msg


def test_proc_rules_fire_only_on_proc_ticks():
    plan = FaultPlan(parse_fault_spec("proc:kill@step=1"), seed=0)
    assert plan.intercept("push", 0) is None
    plan = FaultPlan(parse_fault_spec("proc:kill@step=1"), seed=0)
    inj = plan.intercept("proc", -1)
    assert inj is not None and inj.kind == "kill"
    assert plan.counters()["kill"] == 1


def test_proc_index_filters_by_wid():
    rules = parse_fault_spec("proc1:kill@step=1")
    assert FaultPlan(rules, seed=0, worker_id=0).intercept(
        "proc", -1) is None
    inj = FaultPlan(rules, seed=0, worker_id=1).intercept("proc", -1)
    assert inj is not None and inj.kind == "kill"


# ---- exit reasons, restart, signals -----------------------------------------
def test_supervisor_classifies_exit_reasons():
    sup = Supervisor(grace_ms=2000)
    sup.spawn(argv=_child_argv("raise SystemExit(0)"))
    sup.spawn(argv=_child_argv("raise SystemExit(5)"))
    sup.spawn(argv=_child_argv(
        "import os, signal; os.kill(os.getpid(), signal.SIGKILL)"))
    try:
        assert sup.wait_all(timeout_s=_T, poll_ms=20)
    finally:
        sup.shutdown()
    assert sup.exit_reasons == {
        0: ["clean"], 1: ["error:rc=5"], 2: ["signal:SIGKILL"]}
    snap = _counters()
    assert snap["supervisor.spawns"] == 3
    assert snap["supervisor.exits"] == 3
    assert snap["supervisor.exit.clean"] == 1
    assert snap["supervisor.exit.error"] == 1
    assert snap["supervisor.exit.signal"] == 1
    events = [e for e in get_flight_recorder().events()
              if e["event"] == "supervisor.exit"]
    assert sorted(e["args"]["reason"] for e in events) == [
        "clean", "error:rc=5", "signal:SIGKILL"]
    assert all(e["args"]["pid"] > 0 for e in events)


def test_restart_backoff_then_giveup():
    """A crash-looping child restarts with doubling backoff, then is given
    up past the limit — never a hot respawn loop."""
    sup = Supervisor(restart_limit=2, backoff_ms=30)
    sup.spawn(argv=_child_argv("raise SystemExit(1)"), auto_restart=True)
    try:
        assert sup.wait_all(timeout_s=_T, poll_ms=20)
    finally:
        sup.shutdown()
    assert sup.exit_reasons[0] == ["error:rc=1"] * 3
    snap = _counters()
    assert snap["supervisor.restarts"] == 2
    assert snap["supervisor.giveups"] == 1
    assert sup.live() == []
    names = [e["event"] for e in get_flight_recorder().events()]
    assert names.count("supervisor.restart") == 2
    assert names.count("supervisor.giveup") == 1


def test_proc_kill_fault_is_a_real_sigkill():
    sup = Supervisor(fault_spec="proc:kill@step=3")
    sup.spawn(argv=_child_argv("import time; time.sleep(60)"))
    pid = sup.child(0).pid
    try:
        assert sup.wait_all(timeout_s=_T, poll_ms=20)
    finally:
        sup.shutdown()
    assert sup.exit_reasons[0] == ["signal:SIGKILL"]
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)  # really dead, not emulated


def test_proc_restart_fault_respawns():
    """proc:restart@step=2 — SIGKILL + respawn; the second life carries
    BYTEPS_SUPERVISOR_RESTARTS=1 and runs to completion. A respawned
    child gets a fresh plan (as in the reference), so a second life still
    running at its second poll tick would be killed again: this test
    steps the supervisor itself and lets the second life exit before the
    next tick, so exactly one restart happens."""
    sup = Supervisor(fault_spec="proc:restart@step=2", backoff_ms=20)
    sup.spawn(argv=_child_argv(
        "import os, sys, time\n"
        "if os.environ.get('BYTEPS_SUPERVISOR_RESTARTS') == '0':\n"
        "    time.sleep(60)\n"
        "sys.exit(0)\n"))
    first = sup.child(0).pid
    try:
        deadline = time.monotonic() + _T
        while sup.child(0).pid == first:      # kill, reap, back off, respawn
            assert time.monotonic() < deadline, "never respawned"
            sup.poll()
            time.sleep(0.02)
        sup.child(0).wait(timeout=_T)         # no tick in the second life
        assert sup.wait_all(timeout_s=_T, poll_ms=20)
    finally:
        sup.shutdown()
    assert sup.exit_reasons[0] == ["signal:SIGKILL", "clean"]
    assert _counters()["supervisor.restarts"] == 1


def test_respawned_child_gets_a_fresh_plan():
    """The reference's behaviour the test above steps around, pinned: a
    second life still running at its second tick is killed again, until
    the restart limit gives it up."""
    sup = Supervisor(fault_spec="proc:restart@step=2", backoff_ms=20,
                     restart_limit=2)
    sup.spawn(argv=_child_argv("import time; time.sleep(60)"))
    try:
        assert sup.wait_all(timeout_s=_T, poll_ms=20)
    finally:
        sup.shutdown()
    assert sup.exit_reasons[0] == ["signal:SIGKILL"] * 3
    snap = _counters()
    assert snap["supervisor.restarts"] == 2
    assert snap["supervisor.giveups"] == 1


def test_retire_escalates_sigterm_to_sigkill(tmp_path):
    """A child that ignores SIGTERM past the grace window is SIGKILLed
    by the tick — retire always converges."""
    ready = tmp_path / "ready"
    sup = Supervisor(grace_ms=300)
    sup.spawn(argv=_child_argv(
        "import pathlib, signal, sys, time\n"
        "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
        "pathlib.Path(sys.argv[1]).touch()\n"
        "time.sleep(60)\n") + [str(ready)])
    deadline = time.monotonic() + _T
    while not ready.exists():      # its SIG_IGN is in place first
        assert time.monotonic() < deadline, "child never got ready"
        time.sleep(0.01)
    sup.retire(0)
    try:
        assert sup.wait_all(timeout_s=_T, poll_ms=20)
    finally:
        sup.shutdown()
    assert sup.exit_reasons[0] == ["signal:SIGKILL"]
    assert _counters()["supervisor.retired"] == 1
    exit_ev = [e for e in get_flight_recorder().events()
               if e["event"] == "supervisor.exit"][0]
    assert exit_ev["args"]["retired"] is True


# ---- policy admit → kJoin, evict → lease, against a port server ----------
def _child_env(**kv):
    env = {"PYTHONPATH": REPO}
    env.update({k: str(v) for k, v in kv.items()})
    return env


def test_policy_admit_and_evict_against_real_processes():
    port_lib()
    port = next_port()
    start_server(port=port, num_workers=1, engine_threads=2,
                 async_mode=False, lease_ms=800)
    w0 = PSWorker(servers=[("127.0.0.1", port)], worker_id=0,
                  health_interval_ms=150)
    sup = Supervisor(first_wid=1, base_env=_child_env(
        BYTEPS_CHILD_SERVERS=f"127.0.0.1:{port}", BYTEPS_CHILD_ROUNDS=0))
    policy = ScalingPolicy(scale_up_load=1.0, scale_down_load=0.2,
                           cooldown=0, sustain=1, min_units=1,
                           max_units=2, domain="proc")

    def members():
        ep, live, _bits = w0._conn(0).members()
        return ep, live

    try:
        d = policy.observe(Sample(live=1, load=2.0))
        assert d.action == "admit"
        wid = sup.execute(d)
        assert wid == 1
        deadline = time.monotonic() + _T
        while time.monotonic() < deadline:
            sup.poll()
            ep, live = members()
            if live == 2:
                break
            time.sleep(0.1)
        assert live == 2, "admitted child never joined"
        epoch_after_join = ep
        assert epoch_after_join >= 1

        d = policy.observe(Sample(live=2, load=0.05))
        assert d.action == "evict"
        assert sup.execute(d) == wid
        deadline = time.monotonic() + _T
        while time.monotonic() < deadline:
            sup.poll()
            w0.ping(0)  # keep the parent's own lease warm
            ep, live = members()
            if live == 1 and ep > epoch_after_join:
                break
            time.sleep(0.1)
        assert live == 1, "evicted child still holds membership"
        assert ep == epoch_after_join + 1  # exactly one lease eviction
        assert sup.wait_all(timeout_s=_T, poll_ms=20)
    finally:
        sup.shutdown()
        w0.shutdown()
    assert sup.exit_reasons[wid] == ["clean"]
    snap = metrics_snapshot()
    json.dumps(snap)
    c = snap["metrics"]["counters"]
    assert c["autoscaler.decisions"] == 2
    assert c["autoscaler.proc.admit"] == 1
    assert c["autoscaler.proc.evict"] == 1
    assert c["supervisor.spawns"] == 1
    assert c["supervisor.retired"] == 1
    assert c["supervisor.exit.clean"] == 1
    names = [e["event"] for e in get_flight_recorder().events()]
    assert names.count("autoscaler.decision") == 2
    assert names.count("supervisor.execute") == 2
    assert "supervisor.spawn" in names
    assert "supervisor.exit" in names


# ---- crash-resume through the supervisor ------------------------------------
ROUNDS = 6
LEASE_MS = 10000


def _supervised_run(port, ckpt, out, kill_at=None):
    # the lease runs from the server's start, and a checkpointing child
    # first speaks after its interpreter and torch import (seconds on a
    # loaded host): a lease shorter than that evicts it before round 0
    start_server(port=port, num_workers=1, engine_threads=2,
                 async_mode=False, lease_ms=LEASE_MS)
    sup = Supervisor(backoff_ms=50, base_env=_child_env(
        BYTEPS_CHILD_SERVERS=f"127.0.0.1:{port}",
        BYTEPS_CHILD_ROUNDS=ROUNDS, BYTEPS_CHILD_PIN=1,
        BYTEPS_CHILD_CKPT=ckpt, BYTEPS_CHILD_OUT=out,
        BYTEPS_CHILD_ROUND_DELAY_MS=150))
    sup.spawn(auto_restart=True)
    try:
        if kill_at is not None:
            progress = str(out) + ".progress"
            deadline = time.monotonic() + _T
            while time.monotonic() < deadline:
                done = (open(progress).read().splitlines()
                        if os.path.exists(progress) else [])
                if len(done) > kill_at:
                    break
                time.sleep(0.05)
            else:
                pytest.fail("child never reached the kill round")
            sup.kill(0, signal.SIGKILL)
        assert sup.wait_all(timeout_s=3 * _T, poll_ms=50)
    finally:
        sup.shutdown()
        stop_server()
    return json.loads(open(out).read()), dict(sup.exit_reasons)


def test_crash_resume_bit_identical_to_uninterrupted(tmp_path):
    """SIGKILL a checkpointing child mid-run; the supervisor respawns it,
    the driver restores from the port's Checkpointer and rejoin()s, and
    the final accumulated state is bit-identical to a never-killed run."""
    port_lib()
    clean, _ = _supervised_run(next_port(), tmp_path / "ck_clean",
                               tmp_path / "clean.json")
    crashed, reasons = _supervised_run(next_port(), tmp_path / "ck_crash",
                                       tmp_path / "crash.json", kill_at=2)
    assert reasons[0][0] == "signal:SIGKILL"
    assert reasons[0][-1] == "clean"
    assert crashed["restarts"] >= 1
    assert crashed["resumed_from"] >= 1  # really restored, not a redo
    assert len(clean["rounds"]) == ROUNDS
    assert crashed["state_crc"] == clean["state_crc"]
    assert crashed["state_sum"] == clean["state_sum"]


def _child_job(pkg, tmp_path, port):
    """One ``--child-worker`` of package ``pkg`` (``byteps_tpu`` or
    ``byteps_tpu_torch``) against a server of that package in its own
    process; returns the child's final JSON."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    server = subprocess.Popen(
        [sys.executable, "-c",
         f"from {pkg}.server import start_server, load_lib\n"
         f"start_server(port={port}, num_workers=1, engine_threads=2,\n"
         "             async_mode=False)\n"
         "load_lib().bps_server_wait()\n"], env=env, cwd=REPO)
    out = tmp_path / f"{pkg}.json"
    try:
        child = subprocess.run(
            [sys.executable, "-m", f"{pkg}.launcher", "--child-worker"],
            env=dict(env, DMLC_WORKER_ID="0",
                     BYTEPS_CHILD_SERVERS=f"127.0.0.1:{port}",
                     BYTEPS_CHILD_ROUNDS=str(ROUNDS),
                     BYTEPS_CHILD_ELEMS="300", BYTEPS_CHILD_SEED="99",
                     BYTEPS_CHILD_PIN="1",
                     BYTEPS_CHILD_CKPT=str(tmp_path / f"ck_{pkg}"),
                     BYTEPS_CHILD_OUT=str(out)),
            cwd=REPO, timeout=3 * _T, capture_output=True, text=True)
        assert child.returncode == 0, child.stderr[-2000:]
        assert server.wait(timeout=_T) == 0
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    return json.loads(out.read_text())


def test_child_worker_matches_the_reference_child(tmp_path):
    """The same BYTEPS_CHILD_* environment, each child against its own
    package's server: the same per-round versions and CRCs, the same
    state_crc and state_sum."""
    port_lib()
    ref = _child_job("byteps_tpu", tmp_path, next_port())
    got = _child_job("byteps_tpu_torch", tmp_path, next_port())
    assert got["rounds"] == ref["rounds"]
    assert got["state_crc"] == ref["state_crc"]
    assert got["state_sum"] == ref["state_sum"]
    assert got["resumed_from"] == ref["resumed_from"] == 0
