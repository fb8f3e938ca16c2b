"""The port's bounded staleness (``BYTEPS_STALENESS``) and asynchronous
rounds (``BYTEPS_ENABLE_ASYNC``) against the reference's, on the CPU.

* The K = 1 ladder on the server: a pull within the bound is served the
  newest closed round and stamped with it, a pull past the bound
  force-closes the straggler's round over its contributors (scaled by
  live/contributors), a late push is consumed silently, and a serve-ahead
  pull re-syncs the straggler's mint counter: the port's pulls, served
  rounds and mint counters equal the reference's and numpy's.
* K = 0 is the synchronous tier bit for bit over several rounds.
* ``DcnCore`` arms the scheduler's per-key rounds window at K: round r+K+1
  of a key holds while round r is in flight, then every handle finishes
  with the reference core's bytes.
* A K = 1 straggler (``worker1:slow``) on ``DcnCore``: the fast worker
  completes every round, stale serves show in ``server.staleness``, no
  credit leaks.
* Asynchronous rounds: pushes accumulate without a barrier, as the
  reference's do, and two free-running workers drive a quadratic down.
  The async push after a re-admission (the reference's
  ``tests/test_staleness.py:341``, unsteady there) runs the port alone
  against numpy and is marked slow, as the reference keeps failing it.
"""

import sys
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from dcn_fixtures import job_env  # noqa: E402
from elastic import (packages, reset_configs, run_threads, start,  # noqa: E402
                     wait_until)

KINDS = ("ref", "port")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("BYTEPS_WORKER_LEASE_MS", "BYTEPS_STALENESS",
              "BYTEPS_ENABLE_ASYNC", "BYTEPS_FAULT_SPEC",
              "BYTEPS_HEALTH_INTERVAL_MS", "DMLC_WORKER_ID",
              "BYTEPS_PARTITION_BYTES"):
        monkeypatch.delenv(k, raising=False)
    reset_configs()
    yield
    for kind in KINDS:
        packages(kind)[0].stop_server()
    reset_configs()


def _env(monkeypatch, **kv):
    for k, v in kv.items():
        monkeypatch.setenv(k, str(v))
    reset_configs()


def _registry(kind):
    if kind == "ref":
        from byteps_tpu.common.metrics import get_registry
    else:
        from byteps_tpu_torch.common.metrics import get_registry
    return get_registry()


def _staleness_hist(kind):
    """(count, sum, max) of the process's ``server.staleness`` histogram
    (requested - served, a pull)."""
    h = _registry(kind).snapshot()["histograms"].get("server.staleness", {})
    return h.get("count", 0), h.get("sum", 0.0), h.get("max", 0.0)


def _ladder(kind, monkeypatch):
    """The reference's ``test_staleness_serves_stale_stamps_round_and_
    force_closes`` (``tests/test_staleness.py:50``), K = 1."""
    server, _, _ = packages(kind)
    _env(monkeypatch, BYTEPS_STALENESS=1)
    port = start(kind, num_workers=2, engine_threads=2, async_mode=False,
                 staleness=1)
    servers = [("127.0.0.1", port)]
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal(64).astype(np.float32)
    x1 = rng.standard_normal(64).astype(np.float32)
    out, seen = [], []
    count0, sum0, _ = _staleness_hist(kind)
    w0 = server.PSWorker(servers=servers, worker_id=0, health_interval_ms=0)
    w1 = server.PSWorker(servers=servers, worker_id=1, health_interval_ms=0)

    def pull(w, v):
        out.append(w.pull(0, 64, v).copy())
        seen.append((v, w.last_pull_round()))

    try:
        w0.init_key(0, 256)
        w1.init_key(0, 256)
        v = w0.push(0, x0)
        w1.push(0, x1)
        pull(w0, v)                    # round 1: a real quorum sum
        pull(w0, w0.push(0, x0))       # round 2: served round 1
        pull(w0, w0.push(0, x0))       # round 3: force-closes round 2
        pull(w1, w1.push(0, x1))       # a late round 2: consumed silently
        for _ in range(2):             # rounds 4, 5 lap the straggler
            pull(w0, w0.push(0, x0))
        pull(w1, w1.push(0, x1))       # round 3, served 4: re-synced
        count, total, _ = _staleness_hist(kind)
        seen.append(("resynced", w1.push(0, x1)))   # the open round 5
        # the server acknowledges a push on receipt and applies it after:
        # poll (served round 4, within the bound) until round 5 closed
        wait_until(lambda: (w0.pull(0, 64, 5) is not None
                            and w0.last_pull_round() == 5),
                   what="round 5's natural close")
        out.append(w0.pull(0, 64, 5).copy())
        return out, seen, count - count0, total - sum0
    finally:
        w0.close()
        w1.close()
        server.stop_server()
        reset_configs()


def test_staleness_serves_stale_stamps_and_force_closes_as_the_reference(
        monkeypatch):
    t, r = (_ladder(k, monkeypatch) for k in ("port", "ref"))
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal(64).astype(np.float32)
    x1 = rng.standard_normal(64).astype(np.float32)
    want = [x0 + x1, x0 + x1, x0 + x0, x0 + x0, None, None, None, x0 + x1]
    assert len(t[0]) == len(r[0]) == len(want)
    for i, (a, b, c) in enumerate(zip(t[0], r[0], want)):
        np.testing.assert_array_equal(a, b, err_msg=f"pull {i}")
        if c is not None:
            np.testing.assert_array_equal(a, c, err_msg=f"pull {i}")
    assert t[1] == r[1]
    assert t[1] == [(1, 1), (2, 1), (3, 2), (2, 2), (4, 3), (5, 4), (3, 4),
                    ("resynced", 5)]
    # the telemetry: requested - served of every pull in the histogram
    assert t[2:] == r[2:] and t[2] >= 7 and t[3] >= 1.0


def _k0_or_sync(kind, staleness):
    server, _, _ = packages(kind)
    rng = np.random.default_rng(11)
    rounds = [(rng.standard_normal(96).astype(np.float32),
               rng.standard_normal(96).astype(np.float32))
              for _ in range(4)]
    kw = {} if staleness is None else {"staleness": staleness}
    port = start(kind, num_workers=2, engine_threads=2, async_mode=False,
                 **kw)
    servers = [("127.0.0.1", port)]
    w0 = server.PSWorker(servers=servers, worker_id=0, health_interval_ms=0)
    w1 = server.PSWorker(servers=servers, worker_id=1, health_interval_ms=0)
    outs = []
    try:
        w0.init_key(0, 384)
        w1.init_key(0, 384)
        for x0, x1 in rounds:
            v = w0.push(0, x0)
            w1.push(0, x1)
            outs.append((w0.pull(0, 96, v).copy(), v, w0.last_pull_round()))
    finally:
        w0.close()
        w1.close()
        server.stop_server()
    return outs, rounds


def test_staleness_k0_bit_identical_to_sync():
    """K = 0 runs the synchronous tier's path: four two-worker rounds are
    bit-identical to the plain tier's and to the reference's, and every
    pull is served the round it asked for."""
    before = _staleness_hist("port")
    port_k0, rounds = _k0_or_sync("port", 0)
    port_sync, _ = _k0_or_sync("port", None)
    ref_k0, _ = _k0_or_sync("ref", 0)
    after = _staleness_hist("port")
    for (a, va, sa), (b, _, _), (c, _, _), (x0, x1) in zip(
            port_k0, port_sync, ref_k0, rounds):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, x0 + x1)
        assert va == sa
    # eight pulls observed, every one of staleness 0
    assert after[0] - before[0] == 8 and after[1] == before[1]


def _window(kind, monkeypatch):
    """Three rounds of one key through a ``DcnCore`` of worker 0 with
    K = 1 on a two-worker server that worker 1 never pushes to, enqueued
    one at a time. Round 1's PULL is held: rounds 1 and 2 issue, round 3
    holds at the window; released, the pulls of rounds 2 and 3
    force-close the rounds before them over worker 0 (scaled by 2)."""
    server, _, _ = packages(kind)
    if kind == "ref":
        from byteps_tpu.common.dcn_adapter import DcnCore
    else:
        from byteps_tpu_torch.common.dcn_adapter import DcnCore
    port = start(kind, num_workers=2, engine_threads=2, async_mode=False,
                 staleness=1)
    job_env(monkeypatch, port, workers=2)
    _env(monkeypatch, BYTEPS_STALENESS=1)
    servers = [("127.0.0.1", port)]
    x = np.linspace(-1, 1, 1000, dtype=np.float32)
    peer = server.PSWorker(servers=servers, worker_id=1,
                           health_interval_ms=0)
    holder, core = {}, None
    try:
        raised = run_threads({
            "core": lambda: holder.update(core=DcnCore(
                servers=servers, worker_id=0)),
            "peer": peer.barrier}, bound=30)
        assert not raised, raised
        core = holder["core"]
        w = core.worker
        gate = threading.Event()
        pull = w.pull_bytes

        def held(key, capacity, version, *a, **k):
            if version == 1:
                assert gate.wait(30)
            return pull(key, capacity, version, *a, **k)

        w.pull_bytes = held
        key = core.registry.declare("w", (1000,), np.float32) \
            .partitions[0].key
        hs = []
        for i in range(3):
            # one at a time, so that handle i mints round i + 1
            hs.append(core.push_pull_async(x + i, name="w"))
            if i < 2:
                wait_until(lambda: w.export_rounds()[0].get(key) == i + 1,
                           what=f"round {i + 1} minted")
        time.sleep(0.3)
        minted_while_held = w.export_rounds()[0][key]
        gate.set()
        outs = [DcnCore.assemble(h, 30) for h in hs]
        return (outs, minted_while_held, w.export_rounds()[0][key],
                core.scheduler._rounds_window,
                core.scheduler.credit_pools())
    finally:
        if core is not None:
            core.shutdown()
        peer.close()
        server.stop_server()
        reset_configs()


def test_dcncore_rounds_window_holds_a_key(monkeypatch):
    t, r = (_window(k, monkeypatch) for k in ("port", "ref"))
    x = np.linspace(-1, 1, 1000, dtype=np.float32)
    want = [x * np.float32(2), x * np.float32(2),
            (x + 1) * np.float32(2)]
    for a, b, c in zip(t[0], r[0], want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert t[1:] == r[1:]
    assert t[1] == 2 and t[2] == 3 and t[3] == 1


def test_dcncore_straggler_k1_completes_at_the_fast_pace(monkeypatch):
    """Two ``DcnCore`` workers, K = 1, worker 1 a straggler (every wire
    attempt 120 ms late, ``worker1:slow``). The fast worker keeps K + 1
    handles in flight and completes every round; it consumed stale
    rounds (``server.staleness`` max >= 1); no credit leaks on either."""
    from byteps_tpu_torch.common.dcn_adapter import DcnCore

    port = start("port", num_workers=2, engine_threads=2, async_mode=False,
                 staleness=1)
    job_env(monkeypatch, port, workers=2)
    _env(monkeypatch, BYTEPS_STALENESS=1,
         BYTEPS_FAULT_SPEC="worker1:slow@ms=120", BYTEPS_FAULT_SEED=0)
    servers = [("127.0.0.1", port)]
    rng = np.random.default_rng(2)
    flats = [rng.standard_normal(65536).astype(np.float32)
             for _ in range(2)]
    rounds, done, pools = 5, {0: [], 1: []}, {}
    count0, sum0, _ = _staleness_hist("port")

    def body(wid):
        def run():
            core = DcnCore(servers=servers, worker_id=wid)
            try:
                pend = deque()
                for _ in range(rounds):
                    pend.append(core.push_pull_async(flats[wid], name="st"))
                    while len(pend) > (1 if wid == 0 else 0):
                        done[wid].append(
                            DcnCore.assemble(pend.popleft(), 60).size)
                while pend:
                    done[wid].append(DcnCore.assemble(pend.popleft(), 60).size)
                core.scheduler.drain(timeout=30)
                pools[wid] = core.scheduler.credit_pools()
            finally:
                core.shutdown()
        return run

    raised = run_threads({"fast": body(0), "slow": body(1)}, bound=90)
    assert not raised, raised
    assert done == {0: [65536] * rounds, 1: [65536] * rounds}
    # every pull observed; some were served a round behind
    count, total, _ = _staleness_hist("port")
    assert count - count0 >= 2 * rounds and total - sum0 >= 1.0
    from byteps_tpu_torch.common.config import get_config

    credit = get_config().scheduling_credit
    assert pools == {0: {0: credit}, 1: {0: credit}}


def _async_accumulates(kind):
    """The reference's ``test_async_mode_accumulates_without_barrier``
    (``tests/test_dcn.py:95``)."""
    server, _, _ = packages(kind)
    port = start(kind, num_workers=2, engine_threads=1, async_mode=True)
    w = server.PSWorker(servers=[("127.0.0.1", port)], health_interval_ms=0)
    x = np.ones(8, np.float32)
    try:
        w.init_key(1, x.nbytes)
        w.push(1, x)
        w.push(1, x)
        wait_until(lambda: np.array_equal(w.pull(1, 8, version=1), 2 * x),
                   what="both pushes summed")
        return w.pull(1, 8, version=1).copy()
    finally:
        w.close()
        server.stop_server()


def test_async_accumulates_without_a_barrier():
    """One worker of two pushes twice and pulls at once: no round waits
    for the other worker; the store holds both pushes."""
    t, r = _async_accumulates("port"), _async_accumulates("ref")
    np.testing.assert_array_equal(t, r)
    np.testing.assert_array_equal(t, np.full(8, 2.0, np.float32))


def test_async_two_workers_converge_on_a_quadratic():
    """Asynchronous rounds as the K = inf limit (the reference's
    ``tests/test_staleness.py:395``): the store is the parameter vector
    (zero at init); two free-running workers push -lr·grad and pull the
    current parameters, and the loss falls below 5 % of its start."""
    import byteps_tpu_torch.server as tserver

    port = start("port", num_workers=2, engine_threads=2, async_mode=True)
    servers = [("127.0.0.1", port)]
    dim, steps = 32, 60
    rng = np.random.default_rng(3)
    w_true = rng.standard_normal(dim).astype(np.float32)
    lr = np.float32(0.05)
    final = {}

    def body(wid):
        def run():
            w = tserver.PSWorker(servers=servers, worker_id=wid,
                                 health_interval_ms=0)
            try:
                w.init_key(0, dim * 4)
                params = np.zeros(dim, np.float32)
                for _ in range(steps):
                    grad = 2.0 * (params - w_true)
                    v = w.push(0, (-lr * grad).astype(np.float32))
                    params = w.pull(0, dim, v).copy()
                final[wid] = params
            finally:
                w.close()
        return run

    raised = run_threads({"w0": body(0), "w1": body(1)}, bound=60)
    assert not raised, raised
    loss0 = float(np.sum(w_true ** 2))
    for wid, params in final.items():
        assert float(np.sum((params - w_true) ** 2)) < 0.05 * loss0, wid


@pytest.mark.slow
def test_async_push_validates_bounds_and_liveness(monkeypatch):
    """Asynchronous rounds under a 300 ms lease, over TCP: an out-of-range
    worker id is refused, both workers silent past the lease are evicted
    (the live bitmap empties), an evicted worker's push is refused until
    its heartbeat re-admits it, and then it sums (the reference's
    ``tests/test_staleness.py:341``, the port alone). Slow: the
    reference's own test of it fails in most runs here."""
    import byteps_tpu_torch.server as tserver
    from byteps_tpu_torch.server.native import NativeClient

    _env(monkeypatch, DMLC_NUM_WORKER=2)
    port = start("port", num_workers=2, engine_threads=2, async_mode=True,
                 lease_ms=300)
    x = np.arange(16, dtype=np.float32)
    buf = x.view(np.uint8).ravel()
    c = NativeClient("127.0.0.1", port, 5000, 10000)
    got = np.empty(64, np.uint8)
    try:
        c.init_key(0, 64)
        with pytest.raises(RuntimeError, match="out of range"):
            c.push(0, buf, 0, worker_id=7, version=1)
        c.push(0, buf, 0, worker_id=1, version=1)
        n, _ = c.pull(0, got, 1, worker_id=1)
        np.testing.assert_array_equal(got[:n].view(np.float32), x)
        wait_until(lambda: c.members()[1] == 0, what="both evictions")
        _, live, bits = c.members()
        assert live == 0 and not bits.any()
        with pytest.raises(tserver.WorkerEvictedError):
            c.push(0, buf, 0, worker_id=1, version=2)
        c.ping(worker_id=1)
        c.push(0, buf, 0, worker_id=1, version=2)
        _, live, bits = c.members()
        assert live == 1 and bits[1] == 1 and bits[0] == 0
        n, _ = c.pull(0, got, 1, worker_id=1)
        np.testing.assert_array_equal(got[:n].view(np.float32), x + x)
    finally:
        c.close()
