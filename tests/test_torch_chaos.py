"""The port's DCN robustness (``common/faults.py``, the ``PSWorker``
failover and health monitor, degraded fallback, the handle deadline)
against the reference's, on the CPU. Every comparison is exact: rules,
rendered specs, error messages, injection schedules, placements,
counters, sums and averages are equal, bit for bit where they are
arrays.

* Grammar: every documented rule form parses to the same rules (field by
  field) and renders to the same spec string; a malformed spec raises
  the same error type and message.
* Plans: one spec, seed and worker id give the same (kind, corrupt_at)
  schedule over 1,000 intercepts, ``worker<N>`` scoping included.
* Placement: ``_server_for_live`` agrees for keys 0-999 over every live
  subset of 4 servers.
* Workers under faults: one worker's ``push_pull`` under injected ack
  loss and corruption returns its input and the reference's counters;
  the ``DcnCore`` chaos smoke converges with no credit leaked; two
  workers through a server-down window sum as in the clean run; a worker
  that injects its own death or a down window fails as the reference's.
* Failover: the health monitor fails a dead server over (a killed server
  process, or an open down window) and later sums are exact; a port
  worker and a reference worker fail over together and their sums stay
  exact.
* Degraded: ``DcnCore`` degrades to the local contribution (raw and fp16
  wire) as the reference does, and fails the handle under
  ``BYTEPS_DEGRADED_OK=0``; ``synchronize`` scales a mixed handle slice
  by slice; a 2-rank hybrid pod whose controller lost every server
  returns the pod average, equal to the reference pod's and to the eager
  ICI result.
* The handle deadline, and the knobs ``check_ported`` now accepts or
  still refuses.
"""

import dataclasses
import itertools
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from byteps_tpu.common import config as rconfig
from byteps_tpu.common import faults as rfaults
from byteps_tpu_torch.common import config as tconfig
from byteps_tpu_torch.common import faults as tfaults

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from dcn_fixtures import next_port, port_lib, reference_lib  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# every rule form the reference's grammar tests name, and one of each
# scope the port only parses (replica, tenant, proc)
GOOD_SPECS = [
    "push:timeout@p=0.05;server1:down@step=40..55;pull:corrupt@p=0.01;"
    "all:slow@p=0.5,ms=10;server0:down;push:kill@op=7",
    "server2:down@step=100..",
    "push:timeout@p=0.05", "pull:corrupt@p=0.01",
    "server1:down@step=40..55", "server1:down", "all:slow@p=0.5,ms=20",
    "init:kill@op=1", "push:kill@op=7", "worker:kill@step=8..",
    "worker:hang@step=3,ms=250", "worker:hang@step=3", "worker1:slow@ms=80",
    "worker0:kill@step=8..", "worker2:hang@step=3,ms=250",
    "worker2:join@step=12", "worker0:join@step=3..5", "worker4:join@step=7..",
    "replica1:kill@op=3", "tenant3:slow@ms=40", "proc:kill@step=2",
    "proc1:restart@p=0.1",
]
BAD_SPECS = [
    "push:explode", "push:timeout@q=1", "flux:timeout", "push:timeout@p=x",
    "serverX:down", "server:down", "server1x:down", "worker1x:slow",
    "push:kill@op=x", "server1:down@step=1..y", "all:slow@ms=fast",
    "pull:hang", "pull:join@step=1", "worker2:join", "worker2:join@p=0.5",
    "tenant:slow", "tenant3:kill", "proc1:slow", "push:restart",
    "replica2:corrupt",
]


def _fields(rules):
    return [dataclasses.asdict(r) for r in rules]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_grammar_parses_and_renders_as_the_reference(spec):
    t, r = tfaults.parse_fault_spec(spec), rfaults.parse_fault_spec(spec)
    assert _fields(t) == _fields(r)
    assert tfaults.rules_to_spec(t) == rfaults.rules_to_spec(r)
    assert tfaults.parse_fault_spec(tfaults.rules_to_spec(t)) == t
    assert tfaults.churn_events(t) == rfaults.churn_events(r)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_grammar_refuses_as_the_reference(spec):
    with pytest.raises(Exception) as te:
        tfaults.parse_fault_spec(spec)
    with pytest.raises(Exception) as re_:
        rfaults.parse_fault_spec(spec)
    assert type(te.value) is type(re_.value) is ValueError
    assert str(te.value) == str(re_.value)


# (spec, seed, worker id, the op and server of intercept i)
PLANS = [
    ("push:timeout@p=0.3;pull:corrupt@p=0.2;server0:down@op=50..60", 11, 3,
     lambda i: ("push" if i % 2 == 0 else "pull", i % 2)),
    ("worker1:slow@ms=0;worker1:kill@op=500..;all:timeout@p=0.1", 0, 1,
     lambda i: (("push", "pull", "ping")[i % 3], 0)),
    ("worker1:slow@ms=0;worker1:kill@op=500..;all:timeout@p=0.1", 0, 0,
     lambda i: (("push", "pull", "ping")[i % 3], 0)),
    ("init:kill@p=0.5;server1:down@step=100..200;all:corrupt@p=0.05", 7, 2,
     lambda i: (("init", "push", "pull", "ping")[i % 4], i % 3)),
    ("worker:hang@op=900..,ms=0;push:kill@p=0.01;pull:timeout@p=0.02", 5, 9,
     lambda i: (("push", "pull")[i % 2], i % 4)),
]


@pytest.mark.parametrize("spec,seed,wid,op", PLANS)
def test_plan_schedule_equals_the_reference(spec, seed, wid, op):
    plans = [mod.FaultPlan(mod.parse_fault_spec(spec), seed=seed,
                           worker_id=wid) for mod in (tfaults, rfaults)]
    scheds = [[], []]
    for i in range(1000):
        for plan, sched in zip(plans, scheds):
            inj = plan.intercept(*op(i))
            sched.append(None if inj is None else (inj.kind, inj.corrupt_at))
    assert scheds[0] == scheds[1]
    assert any(scheds[0])
    assert plans[0].counters() == plans[1].counters()
    assert plans[0].step == plans[1].step == 1000


LIVE_SETS = [set(c) for k in range(5)
             for c in itertools.combinations(range(4), k)]


@pytest.mark.parametrize("live", LIVE_SETS,
                         ids=["".join(map(str, sorted(s))) or "none"
                              for s in LIVE_SETS])
def test_placement_over_every_live_set(live):
    from byteps_tpu.server import PSWorker as RWorker
    from byteps_tpu_torch.server import PSWorker as TWorker

    servers = [("127.0.0.1", 1 + i) for i in range(4)]
    t = TWorker(servers=servers, health_interval_ms=0)
    r = RWorker(servers=servers, health_interval_ms=0)
    for key in range(1000):
        assert t._server_for_live(key, live) == r._server_for_live(key, live)
    t._live = r._live = set(live)
    assert [t.server_for(k) for k in range(64)] == \
        [r.server_for(k) for k in range(64)]


# --- one process, one server of each library ----------------------------
@pytest.fixture
def env(monkeypatch):
    """Set the knobs of both packages: ``env(**{"BYTEPS_X": "1"})``."""
    def set_(**kv):
        for k, v in kv.items():
            monkeypatch.setenv(k, v)
        tconfig.reset_config()
        rconfig.reset_config()
    for k in list(os.environ):
        if k.startswith(("BYTEPS_", "DMLC_")):
            monkeypatch.delenv(k)
    set_()
    yield set_
    tconfig.reset_config()
    rconfig.reset_config()


@pytest.fixture
def serve():
    """``serve(kind, workers)`` starts the library's in-process server on
    a free port and returns its address list; stopped at teardown."""
    from byteps_tpu import server as rserver
    from byteps_tpu_torch import server as tserver

    reference_lib()
    port_lib()
    started = []

    def start(kind, workers=1):
        mod = {"ref": rserver, "port": tserver}[kind]
        port = tserver.any_port(
            lambda p: mod.start_server(port=p, num_workers=workers,
                                       engine_threads=2,
                                       pull_timeout_ms=20000), next_port())
        started.append(mod)
        return [("127.0.0.1", port)]

    yield start
    for mod in started:
        mod.stop_server()


def _workers(servers, **kw):
    from byteps_tpu.server import PSWorker as RWorker
    from byteps_tpu_torch.server import PSWorker as TWorker

    return TWorker(servers=servers["port"], **kw), \
        RWorker(servers=servers["ref"], **kw)


def _common(t: dict, r: dict) -> dict:
    keys = sorted(set(t) & set(r))
    assert {"retries", "crc_errors", "give_ups", "failovers", "reinits",
            "ici_fallbacks", "injected_timeout"} <= set(keys), keys
    return {k: (t[k], r[k]) for k in keys if t[k] != r[k]}


def test_one_worker_under_faults_counts_as_the_reference(env, serve):
    env(BYTEPS_RETRY_LIMIT="6", BYTEPS_RETRY_BACKOFF_MS="2",
        BYTEPS_FAULT_SPEC="push:timeout@p=0.25;pull:corrupt@p=0.25",
        BYTEPS_FAULT_SEED="3")
    t, r = _workers({"port": serve("port"), "ref": serve("ref")},
                    worker_id=0)
    x = np.linspace(-1, 1, 256, dtype=np.float32)
    for w in (t, r):
        w.init_key(1, x.nbytes)
        for _ in range(25):
            np.testing.assert_array_equal(w.push_pull(1, x), x)
    tc, rc = t.get_counters(), r.get_counters()
    assert _common(tc, rc) == {}
    assert tc["retries"] > 0 and tc["crc_errors"] > 0, tc
    assert tc["injected_timeout"] > 0 and tc["injected_corrupt"] > 0, tc
    assert tc["give_ups"] == 0, tc
    t.shutdown()
    r.shutdown()


@pytest.mark.parametrize("spec,op_ok", [("worker:kill@op=4", 3),
                                        ("server0:down@op=2..", 1)])
def test_injected_death_and_down_fail_as_the_reference(env, serve, spec,
                                                       op_ok):
    """Plan ops: init, then push and pull per round. A worker:kill is
    sticky and never retried; a down window outlasting the retry budget
    gives up with ServerDownError; both after the same op count."""
    env(BYTEPS_RETRY_LIMIT="2", BYTEPS_RETRY_BACKOFF_MS="1",
        BYTEPS_FAULT_SPEC=spec)
    t, r = _workers({"port": serve("port"), "ref": serve("ref")},
                    worker_id=0)
    x = np.arange(16, dtype=np.float32)
    got = []
    for w in (t, r):
        w.init_key(0, x.nbytes)
        done = 0
        with pytest.raises(Exception) as e:
            for _ in range(4):
                np.testing.assert_array_equal(w.push_pull(0, x), x)
                done += 1
        with pytest.raises(type(e.value)):
            w.ping(0)
        got.append((type(e.value).__name__, str(e.value), done,
                    w._plan.step, w.get_counters()["give_ups"]))
    assert got[0] == got[1]
    assert got[0][2] == op_ok // 2
    t.close()
    r.close()


def test_dcncore_chaos_smoke_converges(env, serve):
    from byteps_tpu.common.dcn_adapter import DcnCore as RCore
    from byteps_tpu_torch.common.dcn_adapter import DcnCore as TCore

    env(BYTEPS_RETRY_LIMIT="6", BYTEPS_RETRY_BACKOFF_MS="2",
        BYTEPS_FAULT_SPEC="push:timeout@p=0.2;pull:corrupt@p=0.2",
        BYTEPS_FAULT_SEED="1", DMLC_NUM_WORKER="1", DMLC_NUM_SERVER="1")
    flat = np.random.default_rng(0).standard_normal(16384).astype(np.float32)
    counts = {}
    for kind, Core in (("port", TCore), ("ref", RCore)):
        core = Core(servers=serve(kind))
        try:
            for _ in range(20):
                h = core.push_pull_async(flat, name="chaos_smoke")
                np.testing.assert_array_equal(
                    Core.assemble(h, timeout=60.0), flat)
            c = counts[kind] = core.worker.get_counters()
            assert c["retries"] > 0 and c["injected_timeout"] > 0, c
            assert c["injected_corrupt"] > 0 and c["give_ups"] == 0, c
            sched = core.scheduler
            assert sched._credits == sched._credit_total
        finally:
            core.shutdown()
    assert counts["port"]["failovers"] == counts["ref"]["failovers"] == 0


def _rounds(make, servers, data, keys, rounds, between=None, each=None):
    """Two workers on threads push and pull ``rounds`` rounds of
    ``keys``; ``between(round)`` runs once both finished that round, then
    ``each(worker, round)`` on each worker. Returns each worker's pulled
    sums and counters."""
    out, counters, errors = {}, {}, {}
    gate = threading.Barrier(2)

    def body(wid):
        try:
            w = make(wid, servers)
            for k in keys:
                w.init_key(k, data[wid][k].nbytes)
            w.barrier()
            res = []
            for i in range(rounds):
                vs = [w.push(k, data[wid][k]) for k in keys]
                res.append([w.pull(k, data[wid][k].size, v).copy()
                            for k, v in zip(keys, vs)])
                if between is not None and gate.wait(30) == 0:
                    between(i)
                if between is not None:
                    gate.wait(30)
                if each is not None:
                    each(w, i)
            out[wid] = res
            counters[wid] = (w.get_counters(), sorted(w.live_servers()))
            w.shutdown()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors[wid] = e
            gate.abort()

    ts = [threading.Thread(target=body, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive(), "a worker hung"
    assert not errors, errors
    return out, counters


def test_two_workers_through_a_down_window_sum_as_clean(env, serve):
    from byteps_tpu_torch.server import PSWorker

    rng = np.random.default_rng(11)
    keys, rounds, n = [0, 1], 30, 512
    data = {w: {k: rng.standard_normal(n).astype(np.float32) for k in keys}
            for w in range(2)}
    runs = []
    for spec in ("", "push:timeout@p=0.05;server0:down@step=40..55"):
        env(BYTEPS_RETRY_LIMIT="30", BYTEPS_RETRY_BACKOFF_MS="1",
            BYTEPS_FAULT_SPEC=spec, BYTEPS_FAULT_SEED="2")
        runs.append(_rounds(
            lambda wid, s: PSWorker(servers=s, worker_id=wid),
            serve("port", workers=2), data, keys, rounds))
        from byteps_tpu_torch.server import stop_server
        stop_server()
    (clean, _), (chaos, counters) = runs
    total = {k: sum(c[k] for c, _ in counters.values())
             for k in counters[0][0]}
    assert total["retries"] > 0, total
    assert total["injected_timeout"] + total["injected_down"] > 0, total
    for wid in range(2):
        for i in range(rounds):
            for j, k in enumerate(keys):
                np.testing.assert_array_equal(chaos[wid][i][j],
                                              clean[wid][i][j])
                np.testing.assert_array_equal(
                    clean[wid][i][j], data[0][k] + data[1][k])


_SERVER = ("from byteps_tpu_torch.server import start_server;"
           "from byteps_tpu_torch.server.native import load_lib;"
           "start_server(port={port}, num_workers={n}, engine_threads=1);"
           "print('up', flush=True);"
           "load_lib().bps_server_wait()")


@pytest.fixture
def subprocess_server():
    """``start(workers)``: a port server in a child process on a free
    port; returns (process, address). Killed at teardown if alive."""
    procs = []

    def start(workers=1):
        from byteps_tpu_torch.server import native
        native.build()
        for _ in range(8):
            port = next_port()
            p = subprocess.Popen(
                [sys.executable, "-c", _SERVER.format(port=port, n=workers)],
                env={**os.environ, "PYTHONPATH": str(ROOT)}, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
            procs.append(p)
            if p.stdout.readline().strip() == "up":
                return p, ("127.0.0.1", port)
            p.wait(timeout=30)
        raise RuntimeError("no child server came up")

    yield start
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _await_failover(workers, live, bound=15.0):
    end = time.monotonic() + bound
    while any(w.live_servers() != live for w in workers):
        assert time.monotonic() < end, [w.live_servers() for w in workers]
        time.sleep(0.01)


@pytest.mark.parametrize("how", ["kill", "window"])
def test_monitor_fails_a_dead_server_over(env, serve, subprocess_server,
                                          how):
    """Key 1 lives on server 1 until server 1 dies: its process is killed,
    or the plan opens a down window from op 30 on (the monitor's pings
    tick the plan). After the monitor's failover the key's next rounds
    land on server 0, re-inited there, and sum exactly."""
    from byteps_tpu.server import PSWorker as RWorker
    from byteps_tpu_torch.server import PSWorker as TWorker

    env(BYTEPS_RETRY_LIMIT="2", BYTEPS_RETRY_BACKOFF_MS="1",
        BYTEPS_HEALTH_MISS_LIMIT="2",
        BYTEPS_FAULT_SPEC="server1:down@op=30.." if how == "window" else "")
    kinds = ["port"] + (["ref"] if how == "window" else [])
    x = np.arange(64, dtype=np.float32)
    counters = []
    for kind in kinds:
        child, addr = subprocess_server()
        Worker = {"port": TWorker, "ref": RWorker}[kind]
        w = Worker(servers=serve(kind) + [addr], worker_id=0,
                   health_interval_ms=20)
        for k in (0, 1):
            w.init_key(k, x.nbytes)
            np.testing.assert_array_equal(w.push_pull(k, x), x)
        assert w.server_for(1) == 1
        if how == "kill":
            child.send_signal(signal.SIGKILL)
        _await_failover([w], {0})
        assert w.server_for(1) == 0
        for _ in range(3):
            np.testing.assert_array_equal(w.push_pull(1, x), x)
        c = w.get_counters()
        counters.append({k: c[k] for k in ("failovers", "give_ups")})
        assert c["failovers"] == 1 and c["reinits"] >= 1, c
        assert c["health_misses_s1"] >= 2, c
        w.shutdown()
        child.kill()
        child.wait()
    assert all(c == counters[0] for c in counters)


def test_port_and_reference_workers_fail_over_together(env, serve,
                                                       subprocess_server):
    """Worker 0 is the port's, worker 1 the reference's, on a port server
    in this process and one in a child. Between two rounds the child is
    killed; both monitors fail it over, both place its keys on server 0
    (re-inited there, with fresh rounds), and every round's sums are
    a + b exactly. (Both monitors need not trip within one probe timeout
    of each other: the failover barrier is best-effort, and the shared
    placement alone makes the survivor sum both workers' fresh rounds.)"""
    from byteps_tpu.server import PSWorker as RWorker
    from byteps_tpu_torch.server import PSWorker as TWorker

    env(BYTEPS_RETRY_LIMIT="30", BYTEPS_RETRY_BACKOFF_MS="2",
        BYTEPS_HEALTH_MISS_LIMIT="2")
    child, addr = subprocess_server(workers=2)
    servers = serve("port", workers=2) + [addr]
    rng = np.random.default_rng(5)
    keys = [0, 1, 2, 3]
    data = {w: {k: rng.standard_normal(300 + k).astype(np.float32)
                for k in keys} for w in range(2)}

    def make(wid, s):
        Worker = TWorker if wid == 0 else RWorker
        return Worker(servers=s, worker_id=wid, health_interval_ms=20)

    def kill(i):
        if i == 1:
            child.send_signal(signal.SIGKILL)

    def settle(w, i):
        # a raw PSWorker has no stage retry to re-run a push whose key
        # moved mid-flight: step on once this worker failed the server over
        if i == 1:
            _await_failover([w], {0})

    out, counters = _rounds(make, servers, data, keys, 4, between=kill,
                            each=settle)
    for wid in range(2):
        for i in range(4):
            for j, k in enumerate(keys):
                np.testing.assert_array_equal(out[wid][i][j],
                                              data[0][k] + data[1][k])
        c, live = counters[wid]
        assert live == [0], (wid, live)
        assert c["failovers"] == 1, (wid, c)
    # the store is shared: whichever worker pushes a moved key (1 and 3)
    # to server 0 first re-inits it there, and the other finds it inited
    assert sum(counters[wid][0]["reinits"] for wid in range(2)) >= 2


@pytest.mark.parametrize("codec", [None, "fp16"])
def test_dcncore_degrades_to_the_local_contribution(env, serve, codec):
    from byteps_tpu.common.dcn_adapter import DcnCore as RCore
    from byteps_tpu.compression.wire import Fp16Wire as RFp16
    from byteps_tpu_torch.common.dcn_adapter import DcnCore as TCore
    from byteps_tpu_torch.compression.wire import Fp16Wire as TFp16

    env(DMLC_NUM_WORKER="1", BYTEPS_MIN_COMPRESS_BYTES="0",
        BYTEPS_PARTITION_BYTES="4096")
    flat = np.random.default_rng(3).standard_normal(3000).astype(np.float32)
    outs, counts = {}, {}
    for kind, Core, wire in (("port", TCore, TFp16), ("ref", RCore, RFp16)):
        core = Core(servers=serve(kind))
        try:
            kw = {"codec": wire()} if codec else {}
            h = core.push_pull_async(flat, name="pre", **kw)
            pre = Core.assemble(h, 30.0)
            core.worker.fail_over(0, barrier=False)
            assert not core.worker.has_live_servers()
            h = core.push_pull_async(flat, name="post", **kw)
            outs[kind] = (pre, Core.assemble(h, 30.0))
            assert sorted(h.degraded_parts) == [0, 1, 2]
            counts[kind] = core.worker.get_counters()["ici_fallbacks"]
        finally:
            core.shutdown()
    for a, b in zip(outs["port"], outs["ref"]):
        np.testing.assert_array_equal(a, b)
    if codec is None:
        np.testing.assert_array_equal(outs["port"][1], flat)
    assert counts["port"] == counts["ref"] == 3


@pytest.mark.parametrize("compression", ["none", "fp16"])
def test_torch_adapter_degrades_to_the_local_average(env, serve, compression):
    """``torch.push_pull`` at ``size()`` 2 over one server (that counts
    one worker per round): a global partition divides by 2, and once the
    server is failed over a degraded one is the local contribution,
    undivided. Port and reference agree bit for bit."""
    import torch

    import byteps_tpu.torch as rt
    import byteps_tpu_torch.torch as tt

    x = torch.from_numpy(
        np.random.default_rng(5).standard_normal(3000).astype(np.float32))
    outs = {}
    for kind, mod in (("port", tt), ("ref", rt)):
        (host, port), = serve(kind)
        env(DMLC_NUM_WORKER="2", DMLC_NUM_SERVER="1", DMLC_WORKER_ID="0",
            DMLC_PS_ROOT_URI=host, DMLC_PS_ROOT_PORT=str(port - 1),
            BYTEPS_MIN_COMPRESS_BYTES="0", BYTEPS_PARTITION_BYTES="4096")
        mod.init()
        try:
            assert mod.size() == 2
            pre = mod.push_pull(x.clone(), name="pre",
                                compression=compression)
            mod._state.core.worker.fail_over(0, barrier=False)
            post = mod.push_pull(x.clone(), name="post",
                                 compression=compression)
            fallbacks = mod._state.core.worker.get_counters()[
                "ici_fallbacks"]
        finally:
            mod.shutdown()
            mod._state.__init__()
        outs[kind] = (pre.numpy(), post.numpy(), fallbacks)
    (tpre, tpost, tn), (rpre, rpost, rn) = outs["port"], outs["ref"]
    np.testing.assert_array_equal(tpre, rpre)
    np.testing.assert_array_equal(tpost, rpost)
    assert tn == rn == 3
    if compression == "none":
        np.testing.assert_array_equal(tpre, x.numpy() / np.float32(2))
        np.testing.assert_array_equal(tpost, x.numpy())


def test_dcncore_strict_mode_fails_the_handle(env, serve):
    from byteps_tpu.common.dcn_adapter import DcnCore as RCore
    from byteps_tpu.common.scheduler import PartitionFailure as RFail
    from byteps_tpu_torch.common.dcn_adapter import DcnCore as TCore
    from byteps_tpu_torch.common.scheduler import PartitionFailure as TFail

    env(DMLC_NUM_WORKER="1", BYTEPS_DEGRADED_OK="0")
    flat = np.linspace(0, 1, 4096, dtype=np.float32)
    msgs = []
    for kind, Core, Fail in (("port", TCore, TFail), ("ref", RCore, RFail)):
        core = Core(servers=serve(kind))
        try:
            core.worker.fail_over(0, barrier=False)
            h = core.push_pull_async(flat, name="strict")
            with pytest.raises(Fail, match="no live summation") as e:
                Core.assemble(h, 30.0)
            msgs.append(str(e.value))
            assert core.scheduler._credits == core.scheduler._credit_total
        finally:
            core.shutdown()
    assert msgs[0] == msgs[1]


def test_synchronize_scales_a_mixed_handle_slice_by_slice(env, serve,
                                                          monkeypatch):
    """A handle whose first partition was summed globally (8 over 4
    workers) and whose second degraded to the local value 3: the port's
    PUSH, PULL and DECOMPRESS stages average it slice by slice, and its
    ``synchronize`` gives the reference's ``[2,2,2,2,3,3,3,3]``."""
    import torch

    import byteps_tpu.torch as rt
    import byteps_tpu_torch.torch as tt
    from byteps_tpu.common.scheduler import Handle as RHandle
    from byteps_tpu_torch.common.dcn_adapter import DcnCore as TCore
    from byteps_tpu_torch.common.scheduler import Handle as THandle
    from byteps_tpu_torch.common.scheduler import PartitionTask

    env(BYTEPS_PARTITION_BYTES="16")
    monkeypatch.setattr(rt._state, "initialized", True)
    monkeypatch.setattr(rt._state, "core", None)  # divide by size()
    monkeypatch.setattr(rt._state, "cfg", dataclasses.replace(
        rconfig.Config(), num_worker=4))
    h = RHandle("t", 2)
    h._partition_done(0, np.full(4, 8.0, np.float32))  # global sum
    h._partition_done(1, np.full(4, 3.0, np.float32))  # local value
    h.average = True
    h.degraded_parts = {1: (4, 4)}
    h.tensor = torch.zeros(8)
    want = rt.synchronize(h).numpy()

    core = TCore(servers=serve("port"))
    try:
        parts = core.registry.declare("t", (8,), np.float32).partitions
        assert [(p.offset, p.length) for p in parts] == [(0, 4), (4, 4)]
        h = THandle("t", 2)
        ctx = {"plans": [None, None], "version": 0, "divisor": 4}
        glob, local = (PartitionTask(p, "t", h, context=ctx) for p in parts)
        glob.payload = np.full(4, 8.0, np.float32).view(np.uint8)  # pulled
        local.payload = np.full(4, 3.0, np.float32).view(np.uint8)
        core.worker.fail_over(0, barrier=False)
        local.payload = core._push_stage(local)
        local.payload = core._pull_stage(local)
        for t in (glob, local):
            h._partition_done(t.partition.part_idx, core._decompress_stage(t))
        assert h.degraded_parts == {1: (4, 4)}
        monkeypatch.setattr(tt._state, "initialized", True)
        h.tensor = torch.zeros(8)
        got = tt.synchronize(h).numpy()
    finally:
        core.shutdown()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.array([2, 2, 2, 2, 3, 3, 3, 3], np.float32))


def test_hybrid_pod_degrades_to_the_pod_average(tmp_path, env):
    """A port pod of two gloo ranks (``tests/helpers/eager_pod.py``
    ``degraded``) and a reference pod on a 2-device CPU mesh, each with
    its own server, whose controllers fail that server over before any
    push: raw (sharded and not, average or sum) and fp16 steps give the
    same rows, equal to the eager ICI result where it is raw."""
    _hybrid_pod_degrades(tmp_path, env, workers="1")


def test_hybrid_pod_of_two_degrades_to_its_own_average(tmp_path, env):
    """The same with two workers (pods) in the job: the degraded average
    still divides by the pod's size alone, not by the job's four ranks.
    No wire is touched, so one pod stands for the job."""
    _hybrid_pod_degrades(tmp_path, env, workers="2")


def _hybrid_pod_degrades(tmp_path, env, workers):
    import jax
    import jax.numpy as jnp

    import byteps_tpu.jax as rbps
    from byteps_tpu_torch.server import start_server_any_port, stop_server

    n, L = 2, 5000
    steps = [("a", None, True), ("s", None, False),
             ("f", {"compressor": "fp16"}, True)]
    xs = {f"x{i}": np.random.RandomState(50 + i).randn(n, L)
          .astype(np.float32) for i in range(len(steps))}
    np.savez(tmp_path / "in.npz", **xs)
    knobs = {"BYTEPS_PARTITION_BYTES": "8192",
             "BYTEPS_MIN_COMPRESS_BYTES": "0"}
    results = {}
    for sharded in ("1", "0"):
        io = tmp_path / f"s{sharded}"
        io.mkdir()
        np.savez(io / "in.npz", **xs)
        (io / "spec.json").write_text(json.dumps(
            {"steps": steps, "ports": [next_port()], "wait_s": 30}))
        penv = {k: v for k, v in os.environ.items()
                if not k.startswith(("BYTEPS_", "DMLC_"))}
        penv.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="",
                    DMLC_NUM_WORKER=workers, DMLC_NUM_SERVER="1",
                    DMLC_PS_ROOT_URI="127.0.0.1", DMLC_WORKER_ID="0",
                    BYTEPS_HYBRID_SHARDED=sharded, **knobs)
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "helpers" / "eager_pod.py"),
             "degraded", str(r), str(n), str(io)], env=penv, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(n)]
        port = start_server_any_port(next_port(), num_workers=1)
        env(DMLC_NUM_WORKER=workers, DMLC_NUM_SERVER="1",
            DMLC_PS_ROOT_URI="127.0.0.1", DMLC_PS_ROOT_PORT=str(port - 1),
            BYTEPS_FORCE_DISTRIBUTED="1", BYTEPS_HYBRID_SHARDED=sharded,
            **knobs)
        mesh = jax.make_mesh((n,), ("dp",), devices=jax.devices()[:n])
        want = []
        try:
            rbps.init(mesh=mesh)
            rbps._state.psworker.fail_over(0, barrier=False)
            for i, (name, params, avg) in enumerate(steps):
                want.append(np.asarray(rbps.push_pull(
                    jnp.asarray(xs[f"x{i}"]), average=avg, name=name,
                    compression_params=params)))
            fallbacks = rbps._state.psworker.get_counters()["ici_fallbacks"]
        finally:
            rbps.shutdown()
            rbps._state.__init__()
            stop_server()
            try:
                res = [p.communicate(timeout=120) for p in procs]
            finally:
                for p in procs:
                    p.kill()
        for p, (so, se) in zip(procs, res):
            assert p.returncode == 0, se[-3000:]
        outs = [dict(np.load(io / f"out{r}.npz")) for r in range(n)]
        assert int(outs[0]["fallbacks"]) == fallbacks > 0
        for i, (name, params, avg) in enumerate(steps):
            pod = xs[f"x{i}"][0] + xs[f"x{i}"][1]
            assert want[i].shape == (L,)
            for o in outs:
                np.testing.assert_array_equal(o[f"r{i}"], want[i])
                if params is None:
                    np.testing.assert_array_equal(o[f"r{i}"], o[f"e{i}"])
                    np.testing.assert_array_equal(
                        o[f"r{i}"], pod / 2 if avg else pod)
        for o in outs:
            assert o["moved"].tolist() == [0, 0]
            assert "failed on the pod controller" in str(o["strict"]) or \
                "no live summation" in str(o["strict"]), o["strict"]
        results[sharded] = [o["r0"] for o in outs]
    np.testing.assert_array_equal(results["1"][0], results["0"][0])


def test_retried_head_does_not_strand_the_credits_behind_it():
    """A PUSH stage retry gives its credit back. While the task backs off,
    COMPRESS hands the freed credits to later partitions, which queue at
    PUSH behind it holding every credit; the retried head then waits for
    a credit that only they can return, so they must pass it. (Reference:
    the same scheduler waits forever here.)"""
    from byteps_tpu_torch.common.partition import Partition
    from byteps_tpu_torch.common.scheduler import (Handle, PartitionTask,
                                                   PipelineScheduler, Stage)

    requeued = threading.Event()
    failed = []

    def push(task):
        key = task.partition.key
        if key == 0 and not failed:
            failed.append(key)
            raise ConnectionError("the first push of key 0 fails")
        if key == 1:             # hold PUSH until key 0 is queued again
            assert requeued.wait(10)
        return key

    sched = PipelineScheduler(
        [Stage("COMPRESS", lambda t: t.payload, credited=True),
         Stage("PUSH", push, credited=True, releases_credit=True,
               retryable=True, retry_backoff_s=0.01)], credit=2)
    requeue = sched._requeue_retry

    def requeue_and_tell(si, task):
        requeue(si, task)
        requeued.set()

    sched._requeue_retry = requeue_and_tell
    h = Handle("t", 4)
    sched.enqueue([PartitionTask(
        partition=Partition(key=k, tensor_id=0, part_idx=k, offset=k,
                            length=1, priority=0),
        name="t", handle=h) for k in range(4)])
    try:
        assert h.wait(10) == {0: 0, 1: 1, 2: 2, 3: 3}
        assert failed == [0]
        assert sched.credit_pools() == {0: 2}
    finally:
        sched.shutdown()


def test_handle_deadline_caps_every_wait(env):
    from byteps_tpu.common.scheduler import Handle as RHandle
    from byteps_tpu.common.scheduler import StallError as RStall
    from byteps_tpu_torch.common.scheduler import Handle as THandle
    from byteps_tpu_torch.common.scheduler import StallError as TStall

    env(BYTEPS_HANDLE_DEADLINE_MS="300")
    msgs = []
    for Handle, Stall in ((THandle, TStall), (RHandle, RStall)):
        h = Handle("stalled", 2)
        h._partition_done(0, "done-part")
        h.diag = lambda: {"retries": 7, "live_servers": [0],
                          "health_last_probe_age_ms": 12}
        for timeout in (None, 60.0):
            t0 = time.monotonic()
            with pytest.raises(Stall) as ei:
                h.wait(timeout)
            assert time.monotonic() - t0 < 5.0
            e = ei.value
            assert isinstance(e, TimeoutError) and e.deadline_capped
            assert e.done_parts == [0] and e.total_parts == 2
            assert "retries" in str(e) and "health_last_probe_age_ms" in str(e)
            msgs.append(str(e))
        h.diag = lambda: 1 / 0
        with pytest.raises(Stall, match="diag_error") as ei:
            h.wait(None)
        msgs.append(str(ei.value))
        with pytest.raises(Stall) as ei:
            h.wait(0.05)                 # a shorter timeout stays its own
        assert not ei.value.deadline_capped
        msgs.append(str(ei.value))
    assert msgs[:4] == msgs[4:]


ROBUST_FIELDS = ("fault_spec", "fault_seed", "retry_limit",
                 "retry_backoff_ms", "wire_crc", "health_interval_ms",
                 "health_miss_limit", "degraded_ok", "handle_deadline_ms")


@pytest.mark.parametrize("values", [
    {},
    {"BYTEPS_FAULT_SPEC": "push:timeout@p=0.1", "BYTEPS_FAULT_SEED": "9",
     "BYTEPS_HEALTH_INTERVAL_MS": "50", "BYTEPS_HEALTH_MISS_LIMIT": "4",
     "BYTEPS_DEGRADED_OK": "0", "BYTEPS_HANDLE_DEADLINE_MS": "1500",
     "BYTEPS_RETRY_LIMIT": "3", "BYTEPS_WIRE_CRC": "1"}],
    ids=["defaults", "set"])
def test_robustness_knobs_parse_and_are_accepted(env, values):
    env(**values)
    t, r = tconfig.get_config(), rconfig.get_config()
    assert {f: getattr(t, f) for f in ROBUST_FIELDS} == \
        {f: getattr(r, f) for f in ROBUST_FIELDS}
    tconfig.check_ported()


@pytest.mark.parametrize("knob,value", [
    ("BYTEPS_ENABLE_ASYNC", "1"), ("BYTEPS_STALENESS", "2"),
    ("BYTEPS_WORKER_LEASE_MS", "500"), ("BYTEPS_ENABLE_IPC", "1"),
    ("BYTEPS_POD_CONTROLLERS", "2"), ("BYTEPS_AUTO_TUNE", "1"),
    ("BYTEPS_FAULT_SPEC", "push:timeout@p=0.1;worker1:join@step=4")])
def test_unported_knobs_and_join_rules_are_refused(env, knob, value):
    """Each knob not ported yet is refused by name; the IPC path and
    several controllers a pod are ported since: accepted, and parsed as
    the reference parses them."""
    env(**{knob: value})
    if knob in ("BYTEPS_ENABLE_IPC", "BYTEPS_POD_CONTROLLERS"):
        tconfig.check_ported()
        t, r = tconfig.get_config(), rconfig.get_config()
        for f in ("enable_ipc", "pod_controllers", "hybrid_sharded",
                  "owner_salt"):
            assert getattr(t, f) == getattr(r, f), f
        assert t.enable_ipc or t.pod_controllers == 2
        return
    name = "join rule" if knob == "BYTEPS_FAULT_SPEC" else knob
    with pytest.raises(RuntimeError, match=f"{name}.*not ported yet"):
        tconfig.check_ported()


def test_malformed_fault_spec_fails_at_start(env):
    env(BYTEPS_FAULT_SPEC="push:explode")
    with pytest.raises(ValueError, match="bad BYTEPS_FAULT_SPEC rule"):
        tconfig.check_ported()


def test_shutdown_survives_a_dead_socket_and_a_gone_server(env, serve):
    """The goodbye rides a fresh connection when the pooled one is dead,
    and a server that is gone is logged at debug with its index."""
    from byteps_tpu_torch.server import PSWorker
    from byteps_tpu_torch.server.native import NativeClient

    env(BYTEPS_RETRY_LIMIT="0")
    servers = serve("port")
    w = PSWorker(servers=servers, worker_id=0, recv_timeout_ms=300)
    x = np.ones(8, np.float32)
    w.init_key(2, x.nbytes)
    w.push_pull(2, x)
    with pytest.raises(TimeoutError):
        w.pull(2, 8, version=99)     # a round that never comes
    assert w._tls.conns[0].is_dead()
    w.shutdown()
    end = time.monotonic() + 5
    while True:                      # the server counted the goodbye
        try:
            NativeClient(*servers[0], timeout_ms=50).close()
        except ConnectionError:
            break
        assert time.monotonic() < end, "the server did not stop"
        time.sleep(0.05)
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    srv_log = logging.getLogger("byteps_tpu_torch.server")
    cap = Capture(level=logging.DEBUG)
    old = srv_log.level
    srv_log.addHandler(cap)
    srv_log.setLevel(logging.DEBUG)
    try:
        PSWorker(servers=servers, worker_id=0, timeout_ms=200).shutdown()
    finally:
        srv_log.removeHandler(cap)
        srv_log.setLevel(old)
    assert any("shutdown of server 0 failed" in m for m in records), records
