"""Several controllers a pod in the port's DCN tier (the sharded pod
wire), against the reference's: partition ownership, owner-scoped
credits, ``DcnCore`` over 1, 2 and 3 controller NICs, and owner
failover. Mirrors ``tests/test_sharded_hybrid.py``.

* ``OwnerTable``: ``owner``, ``owner_in`` and ``fail`` equal the
  reference's over 1–5 controllers, salts 0 and 7 and 2,800 keys.
* Credits: under ``credit_scope="owner"`` one owner's stalled wire does
  not starve a sibling, and every pool refills.
* ``DcnCore`` raw and onebit: the outputs of 1, 2 and 3 controllers are
  bit-equal to each other and to the reference core's with as many
  controllers (each on its own library's server); the NICs' bytes split
  as the reference's and sum to one NIC's.
* Owner death: owner 1's NIC killed from its third wire op on (wire
  retries 1) gives the clean run's bits and bytes and the reference's,
  with one failover and every pool full; an owner that has lost every server in its own
  view fails over instead of degrading; a total outage walks three of
  four owners down, then degrades; ``hand_off_owner`` fences the dead
  worker and the survivors adopt its rounds, as the reference's do;
  ``owner_wire_death`` classifies errors as the reference's does.
"""

import itertools
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from byteps_tpu.common import config as rconfig
from byteps_tpu.common import partition as rpart
from byteps_tpu_torch.common import config as tconfig
from byteps_tpu_torch.common import partition as tpart

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from dcn_fixtures import next_port, port_lib, reference_lib  # noqa: E402

KEYS = [t * tpart.MAX_PARTS_PER_TENSOR + i for t in range(700)
        for i in range(4)]
NELEMS = 120000                 # 8 partitions of 65,536 bytes
CREDIT = 4


@pytest.mark.parametrize("salt", [0, 7])
@pytest.mark.parametrize("n_ctl", [1, 2, 3, 4, 5])
def test_owner_table_matches_reference(n_ctl, salt):
    ref, port = rpart.OwnerTable(n_ctl, salt), tpart.OwnerTable(n_ctl, salt)
    assert [port.owner(k) for k in KEYS] == [ref.owner(k) for k in KEYS]
    for size in range(1, n_ctl + 1):
        for live in itertools.combinations(range(n_ctl), size):
            assert [port.owner_in(k, set(live)) for k in KEYS[::7]] == \
                [ref.owner_in(k, set(live)) for k in KEYS[::7]], live
    for rank in [n_ctl - 1, 0, n_ctl - 1] + list(range(n_ctl)):
        assert port.fail(rank) == ref.fail(rank)
        assert port.live() == ref.live()
        assert [port.owner(k) for k in KEYS] == [ref.owner(k) for k in KEYS]
    assert len(port.live()) == 1     # the last controller is never failed


def test_owner_credit_pools_isolate_and_refill():
    """Owner 0's task holds its pool's only credit while its wire stalls;
    owner 1's three tasks recycle their own pool's credit meanwhile (a
    global pool of 1 would let none of them run), and every pool refills
    once owner 0's wire moves."""
    from byteps_tpu_torch.common.scheduler import (
        Handle,
        PartitionTask,
        PipelineScheduler,
        Stage,
    )

    release = threading.Event()
    done = []

    def fn(task):
        if task.partition.owner == 0:
            release.wait(10.0)
        done.append((task.partition.owner, task.partition.key))
        return task.partition.key

    sched = PipelineScheduler(
        stages=[Stage("W", fn, credited=True, pool_size=4,
                      releases_credit=True)],
        credit=1, credit_scope="owner")

    def mk(key, owner):
        p = tpart.Partition(key=key, tensor_id=0, part_idx=key, offset=0,
                            length=1, priority=0, owner=owner)
        return PartitionTask(partition=p, name="t", handle=Handle("t", 1))

    try:
        sched.enqueue([mk(0, 0), mk(1, 1), mk(2, 1), mk(3, 1)])
        end = time.monotonic() + 5
        while time.monotonic() < end and len(done) < 3:
            time.sleep(0.01)
        assert sorted(done) == [(1, 1), (1, 2), (1, 3)], done
        assert sched.credit_pools() == {0: 0, 1: 1}
        release.set()
        sched.drain(5)
        assert len(done) == 4
        assert sched.credit_pools() == {0: 1, 1: 1}
        sched.set_credit(3)
        assert sched.credit_pools() == {0: 3, 1: 3}
    finally:
        release.set()
        sched.shutdown()
    with pytest.raises(ValueError, match="credit_scope"):
        PipelineScheduler(stages=[], credit_scope="nic")


@pytest.fixture
def pod_env(monkeypatch):
    """One pod on one server: partitions of 65,536 bytes, every one
    compressed; wire retries 1 (a killed NIC gives up fast)."""
    for k, v in (("DMLC_NUM_WORKER", "1"), ("DMLC_NUM_SERVER", "1"),
                 ("BYTEPS_PARTITION_BYTES", "65536"),
                 ("BYTEPS_MIN_COMPRESS_BYTES", "0"),
                 ("BYTEPS_RETRY_LIMIT", "1"),
                 ("BYTEPS_RETRY_BACKOFF_MS", "2")):
        monkeypatch.setenv(k, v)
    for k in ("BYTEPS_POD_CONTROLLERS", "BYTEPS_FAULT_SPEC",
              "BYTEPS_HEALTH_INTERVAL_MS", "DMLC_WORKER_ID"):
        monkeypatch.delenv(k, raising=False)
    reference_lib()
    port_lib()
    tconfig.reset_config()
    rconfig.reset_config()
    yield
    tconfig.reset_config()
    rconfig.reset_config()


def _core_rounds(kind, controllers, codec=None, rounds=3, fault_specs=None,
                 before=None):
    """``rounds`` push_pulls of a seeded vector (+ the round) through a
    ``DcnCore`` of ``controllers`` NICs (``kind`` "port" or "ref") on its
    own library's server. ``before(core, r)`` runs before round r.
    Returns the outputs, the NICs' (pushed, pulled) bytes, the credit
    pools, the owner failovers, the NICs' counters and the degraded
    partitions of the last round."""
    if kind == "port":
        from byteps_tpu_torch import server
        from byteps_tpu_torch.common.dcn_adapter import DcnCore
        from byteps_tpu_torch.compression import wire
    else:
        from byteps_tpu import server
        from byteps_tpu.common.dcn_adapter import DcnCore
        from byteps_tpu.compression import wire
    extra = {} if kind == "port" else {"async_mode": False}
    port = server.start_server_any_port(next_port(), num_workers=1,
                                        engine_threads=2, **extra)
    core = DcnCore(servers=[("127.0.0.1", port)],
                   pod_controllers=controllers, fault_specs=fault_specs)
    outs = []
    try:
        flat = np.random.default_rng(7).standard_normal(NELEMS).astype(
            np.float32)
        c = wire.OnebitWire(scaling=True) if codec == "onebit" else None
        for r in range(rounds):
            if before is not None:
                before(core, r)
            h = core.push_pull_async(flat + r, name="eq", codec=c)
            outs.append(DcnCore.assemble(h, timeout=60.0).copy())
        return {"outs": outs,
                "per_nic": [(w.bytes_pushed, w.bytes_pulled)
                            for w in core.workers],
                "pools": core.scheduler.credit_pools(),
                "failovers": core.owner_failovers,
                "live_owners": core.owners.live(),
                "counters": [w.get_counters() for w in core.workers],
                "degraded": getattr(h, "degraded_parts", None)}
    finally:
        core.shutdown()
        server.stop_server()


@pytest.mark.parametrize("codec", [None, "onebit"])
def test_dcncore_controllers_bit_equal_and_split_as_reference(pod_env,
                                                              codec):
    one = _core_rounds("port", 1, codec)
    total = sum(p for p, _ in one["per_nic"])
    for n in (1, 2, 3):
        port = one if n == 1 else _core_rounds("port", n, codec)
        ref = _core_rounds("ref", n, codec)
        for r, (a, b, c) in enumerate(zip(one["outs"], port["outs"],
                                          ref["outs"])):
            np.testing.assert_array_equal(b.view(np.uint32),
                                          a.view(np.uint32),
                                          err_msg=f"{n} NICs, round {r}")
            np.testing.assert_array_equal(b.view(np.uint32),
                                          c.view(np.uint32),
                                          err_msg=f"{n} NICs, round {r}")
        assert port["per_nic"] == ref["per_nic"]
        assert sum(p for p, _ in port["per_nic"]) == total
        assert sum(1 for p, _ in port["per_nic"] if p > 0) == n
        assert all(v == CREDIT for v in port["pools"].values())
        assert port["pools"].keys() == (set(range(n)) if n > 1 else {0})
    if codec is None:           # one pod: the sum is the input
        np.testing.assert_array_equal(
            one["outs"][0],
            np.random.default_rng(7).standard_normal(NELEMS).astype(
                np.float32))


def test_owner_death_bit_identical_to_clean_and_reference(pod_env):
    clean = _core_rounds("port", 2, rounds=6)
    spec = [None, "push:kill@op=3.."]
    chaos = _core_rounds("port", 2, rounds=6, fault_specs=spec)
    ref = _core_rounds("ref", 2, rounds=6, fault_specs=spec)
    for r, (a, b, c) in enumerate(zip(clean["outs"], chaos["outs"],
                                      ref["outs"])):
        np.testing.assert_array_equal(b, a, err_msg=f"round {r}")
        np.testing.assert_array_equal(b, c, err_msg=f"round {r}")
    assert chaos["failovers"] == ref["failovers"] == 1
    assert chaos["live_owners"] == ref["live_owners"] == {0}
    assert chaos["counters"][1]["injected_kill"] >= 1
    assert all(v == CREDIT for v in chaos["pools"].values())
    assert chaos["per_nic"][0][0] > chaos["per_nic"][1][0]
    # which of owner 1's ops the kill meets first depends on how the pool
    # threads interleave, so the split varies; a killed push moves no
    # byte, so the total is the clean run's
    for run in (chaos, ref):
        assert [sum(c) for c in zip(*run["per_nic"])] == \
            [sum(c) for c in zip(*clean["per_nic"])]
    assert not chaos["degraded"]


def test_per_owner_join_rule_is_refused(pod_env):
    """A ``join`` rule in a per-owner plan, once refused as not ported,
    is accepted: each NIC's plan holds the rules the reference's
    ``FaultPlan`` parses from the same spec."""
    from byteps_tpu.common.faults import parse_fault_spec as rparse
    from byteps_tpu_torch import server as tserver
    from byteps_tpu_torch.common.dcn_adapter import DcnCore

    spec = "push:kill@op=3;worker1:join@step=3"
    port = tserver.start_server_any_port(next_port(), num_workers=1)
    core = None
    try:
        core = DcnCore(servers=[("127.0.0.1", port)], pod_controllers=2,
                       fault_specs=[None, spec])
        assert core.workers[0]._plan is None
        assert [r.to_spec() for r in core.workers[1]._plan.rules] == \
            [r.to_spec() for r in rparse(spec)]
    finally:
        if core is not None:
            core.shutdown()
        tserver.stop_server()


def _lose_servers(owners):
    """``before``: from round 1 on, the NICs of ``owners`` see no live
    server (what a NIC's own health monitor records when it dies)."""
    def before(core, r):
        if r == 1:
            for o in owners:
                core.workers[o]._live.clear()
    return before


def test_owner_that_lost_its_servers_fails_over_not_degrades(pod_env):
    got = _core_rounds("port", 2, rounds=2, before=_lose_servers([1]))
    want = _core_rounds("ref", 2, rounds=2, before=_lose_servers([1]))
    flat = np.random.default_rng(7).standard_normal(NELEMS).astype(
        np.float32)
    for r, (a, b) in enumerate(zip(got["outs"], want["outs"])):
        np.testing.assert_array_equal(a, flat + r)   # global sums still
        np.testing.assert_array_equal(a, b)
    assert got["failovers"] == want["failovers"] == 1
    assert got["live_owners"] == {0}
    assert not got["degraded"] and not want["degraded"]


def test_total_outage_walks_owners_down_then_degrades(pod_env):
    """Each owner's failover costs one stage attempt, so PUSH's attempts
    grow with the controllers: three of four owners fail over, and the
    last degrades to the pod's own contribution (here the sum)."""
    got = _core_rounds("port", 4, rounds=2,
                       before=_lose_servers(range(4)))
    want = _core_rounds("ref", 4, rounds=2,
                        before=_lose_servers(range(4)))
    flat = np.random.default_rng(7).standard_normal(NELEMS).astype(
        np.float32)
    np.testing.assert_array_equal(got["outs"][1], flat + 1)
    np.testing.assert_array_equal(got["outs"][1], want["outs"][1])
    assert got["failovers"] == want["failovers"] == 3
    assert len(got["live_owners"]) == 1
    assert got["degraded"] and sorted(got["degraded"]) == \
        sorted(want["degraded"]) == list(range(8))


def _handoff(mod, pmod):
    workers = [mod.PSWorker(servers=[("127.0.0.1", 1)], worker_id=3)
               for _ in range(2)]
    try:
        owners = pmod.OwnerTable(2)
        minted = [workers[0].mint_version(11), workers[0].mint_version(11),
                  workers[0].mint_version(29)]
        live = mod.hand_off_owner(workers, owners, 0)
        fenced = []
        for pin in (None, 2):
            with pytest.raises(mod.FailedOverError, match="fenced"):
                workers[0].mint_version(11, pinned=pin)
            fenced.append(True)
        adopted = [workers[1].mint_version(11), workers[1].mint_version(29)]
        refused = [mod.hand_off_owner(workers, owners, 0),
                   mod.hand_off_owner(workers, owners, 1)]
        return minted, live, fenced, adopted, refused, owners.live()
    finally:
        for w in workers:
            w.close()


def test_handoff_fences_dead_worker_and_adopts_rounds(pod_env):
    from byteps_tpu import server as rserver
    from byteps_tpu_torch import server as tserver

    got = _handoff(tserver, tpart)
    assert got == _handoff(rserver, rpart)
    minted, live, _, adopted, refused, left = got
    assert minted == [1, 2, 1] and live == {0, 1}
    # the survivor continues the sequence: rounds 3 and 2, not 1 again
    assert adopted == [3, 2] and refused == [None, None] and left == {1}


def test_owner_wire_death_classifies_as_reference():
    from byteps_tpu.common import dcn_adapter as radapter
    from byteps_tpu.common import faults as rfaults
    from byteps_tpu import server as rserver
    from byteps_tpu.server import native as rnative
    from byteps_tpu_torch.common import dcn_adapter as tadapter
    from byteps_tpu_torch.common import faults as tfaults
    from byteps_tpu_torch import server as tserver
    from byteps_tpu_torch.server import native as tnative

    cases = [
        (ConnectionError("socket died"), ConnectionError("socket died"),
         True),
        (tfaults.InjectedConnectionError("kill"),
         rfaults.InjectedConnectionError("kill"), True),
        (TimeoutError("recv"), TimeoutError("recv"), False),
        (tnative.WireCorruption("crc"), rnative.WireCorruption("crc"),
         False),
        (tfaults.ServerDownError("down"), rfaults.ServerDownError("down"),
         False),
        (tserver.NoLiveServersError("dead"),
         rserver.NoLiveServersError("dead"), False),
        (tserver.FailedOverError("moved"), rserver.FailedOverError("moved"),
         False),
        (RuntimeError("kErr: size"), RuntimeError("kErr: size"), False),
    ]
    for t, r, want in cases:
        assert tadapter.owner_wire_death(t) == \
            radapter.owner_wire_death(r) == want, type(t).__name__
