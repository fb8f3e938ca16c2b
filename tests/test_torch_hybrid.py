"""The port's hybrid pipeline (``byteps_tpu_torch.eager`` with the
summation servers): pods of gloo rank processes, each pod's controller
(rank 0) alone on the DCN wire.

* Mixed pods: a reference pod (``byteps_tpu.jax`` on a 2-device CPU mesh,
  ``DMLC_WORKER_ID=0``, in this process) and a port pod (two rank
  processes, ``DMLC_WORKER_ID=1``, ``tests/helpers/eager_pod.py``) on one
  port server, both holding the same rows, sharded and not. Each
  tensor's round is pushed by the reference pod first and then by the
  port pod (the server's fp8 and dithering decode-and-add may fuse into
  an FMA, so their sums depend on arrival order). Raw, fp16, onebit +
  error feedback, top-k, randomk, dithering and fp8, two rounds each:
  every rank's result equals the reference pod's bit for bit, and the
  port controller's pushed payloads equal the reference controller's
  byte for byte.
* Port alone: one pod on its own servers. The sharded graph equals the
  unsharded one bit for bit (raw and onebit + EF); the stage lists are 8
  and 7 long; only the controller moves DCN bytes, as many as the plans
  say; under ``BYTEPS_ICI_TIER=ring`` every compressed REDUCE (onebit,
  top-k) equals the staged tier's on the same chunk. A pod of one rank,
  in this process without a process group, runs every stage, and
  refuses a name's second call before the first is synchronized; a
  backend other than gloo is refused.
* Ordering: two ranks enqueue three tensors of different priorities, one
  of them sleeping between its calls; both finish, with the right sums,
  within a bounded wait.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from dcn_fixtures import job_env, next_port, reference_lib  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HELPER = ROOT / "tests" / "helpers" / "eager_pod.py"
N = 2
L = 10000                       # 3 partitions of 16,384 bytes
PARTITION_BYTES = 16384
CODECS = [("raw", None, False),
          ("fp16", {"compressor": "fp16"}, True),
          ("onebit_ef", {"compressor": "onebit", "ef": "vanilla"}, True),
          ("topk", {"compressor": "topk", "k": 0.01}, True),
          ("randomk", {"compressor": "randomk", "k": 0.05}, True),
          ("dithering", {"compressor": "dithering"}, True),
          ("fp8", {"compressor": "fp8"}, True)]
ROUNDS = 2


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _clean_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BYTEPS_", "DMLC_"))}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="", **extra)
    return env


def _start_pod(scenario, io, env):
    return [subprocess.Popen(
        [sys.executable, str(HELPER), scenario, str(r), str(N), str(io)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(N)]


def _finish_pod(procs, io, timeout=120):
    try:
        res = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, res):
        assert p.returncode == 0, se[-3000:]
        assert json.loads(so.strip().splitlines()[-1])["ok"]
    return [dict(np.load(io / f"out{r}.npz")) for r in range(N)]


def _steps():
    """(name, params, average) a step and its inputs, stacked by rank."""
    steps, xs = [], {}
    for c, (name, params, avg) in enumerate(CODECS):
        x = _rand((N, L), 100 + c)
        for r in range(ROUNDS):
            xs[f"x{len(steps)}"] = x + r
            steps.append((f"c_{name}", params, avg))
    return steps, xs


@pytest.fixture
def port_server():
    from byteps_tpu_torch.server import stop_server

    yield
    stop_server()


@pytest.mark.parametrize("sharded", [True, False])
def test_mixed_pods_pull_bit_equal_results(tmp_path, monkeypatch,
                                           port_server, sharded):
    import byteps_tpu.jax as rbps
    from byteps_tpu.common.config import reset_config as r_reset
    from byteps_tpu_torch.server import start_server_any_port

    reference_lib()
    port = start_server_any_port(next_port(), num_workers=2)
    job_env(monkeypatch, port, workers=2)
    knobs = {"BYTEPS_HYBRID_SHARDED": "1" if sharded else "0",
             "BYTEPS_PARTITION_BYTES": str(PARTITION_BYTES),
             "BYTEPS_MIN_COMPRESS_BYTES": "0"}
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    r_reset()
    steps, xs = _steps()
    np.savez(tmp_path / "in.npz", **xs)
    (tmp_path / "spec.json").write_text(json.dumps({"steps": steps}))
    procs = _start_pod("mixed", tmp_path, _clean_env(
        DMLC_NUM_WORKER="2", DMLC_NUM_SERVER="1",
        DMLC_PS_ROOT_URI="127.0.0.1", DMLC_PS_ROOT_PORT=str(port - 1),
        DMLC_WORKER_ID="1", **knobs))
    mesh = jax.make_mesh((N,), ("dp",), devices=jax.devices()[:N])
    want, ref_pushes = [], []
    try:
        t = threading.Thread(target=rbps.init, kwargs={"mesh": mesh})
        t.start()
        t.join(60)
        assert rbps._state.initialized
        w = rbps._state.psworker
        push, pushes = w.push_bytes, {}

        def recording(key, buf, *a, **k):
            v = push(key, buf, *a, **k)
            pushes[key] = np.array(buf, copy=True)
            return v

        w.push_bytes = recording
        for i, (name, params, avg) in enumerate(steps):
            pushes.clear()
            box = []
            call = threading.Thread(target=lambda: box.append(rbps.push_pull(
                jnp.asarray(xs[f"x{i}"]), average=avg, name=name,
                compression_params=params)))
            call.start()
            parts = -(-L * 4 // PARTITION_BYTES)
            end = time.monotonic() + 60
            while len(pushes) < parts and call.is_alive():
                assert time.monotonic() < end, f"step {i}: reference push"
                time.sleep(0.002)
            (tmp_path / f"go{i}").touch()    # now the port pod's pushes
            call.join(60)
            assert box, f"step {i} ({name}) gave no reference result"
            want.append(np.asarray(box[0]))
            ref_pushes.append(dict(pushes))
    finally:
        rbps.shutdown()
        rbps._state.__init__()
        r_reset()
        outs = _finish_pod(procs, tmp_path)
    for i, (name, params, avg) in enumerate(steps):
        for o in outs:
            np.testing.assert_array_equal(o[f"r{i}"], want[i],
                                          err_msg=f"step {i}: {name}")
        got = {int(k.split("_")[1]): v for k, v in outs[0].items()
               if k.startswith(f"push{i}_")}
        assert sorted(got) == sorted(ref_pushes[i]), name
        for key, buf in ref_pushes[i].items():
            np.testing.assert_array_equal(got[key], buf,
                                          err_msg=f"step {i}: {name}")
    # raw: the two pods' sums of the same rows, exact
    x = xs["x0"]
    np.testing.assert_array_equal(want[0], 2 * (x[0] + x[1]))


ALONE_STEPS = [("g", None, False), ("g", None, False), ("a", None, True),
               ("c", {"compressor": "onebit", "ef": "vanilla"}, True),
               ("c", {"compressor": "onebit", "ef": "vanilla"}, True),
               ("t", {"compressor": "topk", "k": 0.01}, True)]
# sharded staged, unsharded staged, sharded ring, unsharded ring
ALONE_CONFIGS = [{"sharded": True, "tier": "staged"},
                 {"sharded": False, "tier": "staged"},
                 {"sharded": True, "tier": "ring"},
                 {"sharded": False, "tier": "ring"}]


def test_port_pod_alone_sharded_equals_unsharded(tmp_path):
    Lg = 50000                  # 4 partitions of 65,536 bytes
    xs = {f"x{i}": _rand((N, Lg), 200 + i) + (i == 1)
          for i in range(len(ALONE_STEPS))}
    np.savez(tmp_path / "in.npz", **xs)
    (tmp_path / "spec.json").write_text(json.dumps({
        "steps": ALONE_STEPS, "configs": ALONE_CONFIGS,
        "ports": [next_port() for _ in ALONE_CONFIGS]}))
    outs = _finish_pod(_start_pod("alone", tmp_path, _clean_env(
        DMLC_NUM_WORKER="1", DMLC_NUM_SERVER="1",
        DMLC_PS_ROOT_URI="127.0.0.1", BYTEPS_FORCE_DISTRIBUTED="1",
        BYTEPS_PARTITION_BYTES="65536", BYTEPS_MIN_COMPRESS_BYTES="0")),
        tmp_path)
    for c, conf in enumerate(ALONE_CONFIGS):
        for i in range(len(ALONE_STEPS)):
            np.testing.assert_array_equal(outs[0][f"c{c}_r{i}"],
                                          outs[1][f"c{c}_r{i}"])
        stages = 8 if conf["sharded"] else 7
        assert [int(o[f"c{c}_stages"]) for o in outs] == [stages] * N
        # the controller alone moves DCN bytes, the plans' bytes each way
        planned = int(outs[0][f"c{c}_planned"])
        assert list(outs[0][f"c{c}_moved"]) == [planned, planned]
        assert list(outs[1][f"c{c}_moved"]) == [0, 0]
    # sharded == unsharded, bit for bit, raw and onebit + EF (staged)
    for i in range(len(ALONE_STEPS)):
        np.testing.assert_array_equal(outs[0][f"c0_r{i}"],
                                      outs[0][f"c1_r{i}"], err_msg=str(i))
    # one pod, one server: raw sums exact, averages over the two ranks
    x = xs["x0"]
    np.testing.assert_array_equal(outs[0]["c0_r0"], x[0] + x[1])
    np.testing.assert_array_equal(outs[0]["c0_r2"],
                                  (xs["x2"][0] + xs["x2"][1]) / 2)
    # ring tier: every compressed REDUCE equals the staged tier's (3 onebit
    # calls of 4 partitions, 1 top-k call of 4)
    for c in (2, 3):
        for o in outs:
            calls = int(o[f"c{c}_ring_calls"])
            assert calls == 12
            for j in range(calls):
                np.testing.assert_array_equal(o[f"c{c}_ring{j}"],
                                              o[f"c{c}_staged{j}"])
    # the ring's REDUCE is the codec's approximation: not the raw graph's
    assert not np.array_equal(outs[0]["c2_r3"], outs[0]["c0_r3"])


def test_pod_of_one_rank_runs_every_stage(monkeypatch, port_server):
    import torch.distributed as dist

    from byteps_tpu_torch import eager
    from byteps_tpu_torch.common.config import reset_config
    from byteps_tpu_torch.common.metrics import get_registry, reset_registry
    from byteps_tpu_torch.server import start_server_any_port

    assert not dist.is_initialized()
    x = torch.as_tensor(_rand((3000,), 7))
    for sharded, n_stages in ((True, 8), (False, 7)):
        port = start_server_any_port(next_port(), num_workers=1)
        job_env(monkeypatch, port, workers=1)
        monkeypatch.setenv("BYTEPS_FORCE_DISTRIBUTED", "1")
        monkeypatch.setenv("BYTEPS_HYBRID_SHARDED", str(int(sharded)))
        reset_config()
        reset_registry()
        eager.init()
        try:
            names = list(eager._state.stages)
            assert len(names) == n_stages
            # REDUCE runs in the caller's thread, the rest on the scheduler
            assert names[1:] == [s.name for s in
                                 eager._state.scheduler.stages]
            for avg in (False, True):
                out = eager.push_pull(x, average=avg, name="w")
                np.testing.assert_array_equal(out.numpy(), x.numpy())
            hist = get_registry().snapshot("scheduler.stage.")["histograms"]
            for s in names:
                assert hist[f"scheduler.stage.{s}.run_us"]["count"] == 2, s
            assert eager.bytes_moved() == (2 * 12000, 2 * 12000)
        finally:
            eager.shutdown()
            eager._state.__init__()
            reset_config()
        from byteps_tpu_torch.server import stop_server

        stop_server()


def test_hybrid_refuses_a_name_in_flight(monkeypatch, port_server):
    """A name's second hybrid call before ``synchronize`` of its first is
    refused on every rank alike (the controller reuses the name's pinned
    host buffers); after it, the name sums again, and another name may
    be in flight meanwhile."""
    from byteps_tpu_torch import eager
    from byteps_tpu_torch.common.config import reset_config
    from byteps_tpu_torch.server import start_server_any_port

    x, y = (torch.as_tensor(_rand((3000,), s)) for s in (8, 9))
    port = start_server_any_port(next_port(), num_workers=1)
    job_env(monkeypatch, port, workers=1)
    monkeypatch.setenv("BYTEPS_FORCE_DISTRIBUTED", "1")
    reset_config()
    eager.init()
    try:
        h = eager.push_pull_async(x, average=False, name="w")
        with pytest.raises(RuntimeError, match="not synchronized"):
            eager.push_pull_async(y, average=False, name="w")
        other = eager.push_pull_async(y, average=False, name="v")
        np.testing.assert_array_equal(eager.synchronize(h).numpy(),
                                      x.numpy())
        np.testing.assert_array_equal(eager.synchronize(other).numpy(),
                                      y.numpy())
        np.testing.assert_array_equal(
            eager.push_pull(y, average=False, name="w").numpy(), y.numpy())
    finally:
        eager.shutdown()
        eager._state.__init__()
        reset_config()


def test_hybrid_refuses_a_backend_other_than_gloo(monkeypatch):
    """The hybrid tail issues on its own group from its own thread while
    the caller's thread issues REDUCE: gloo allows that, and the pipeline
    refuses any other backend of a pod of several ranks before it
    connects to a server."""
    from byteps_tpu_torch import eager
    from byteps_tpu_torch.common.config import reset_config

    monkeypatch.setenv("BYTEPS_FORCE_DISTRIBUTED", "1")
    monkeypatch.setattr(eager, "world", lambda group=None: (2, 0))
    monkeypatch.setattr(eager.dist, "get_backend", lambda group=None: "nccl")
    reset_config()
    try:
        with pytest.raises(RuntimeError, match="not ported yet"):
            eager.init()
        assert eager._state.psworker is None
    finally:
        eager._state.__init__()
        reset_config()


def test_ordering_across_ranks_with_a_late_rank(tmp_path):
    """Rank 1 sleeps between its three calls (priorities 0, 10, -5), so the
    ranks' schedulers see different arrivals; the collectives still pair
    up and every sum is exact."""
    Lo = 50000
    xs = {f"x{i}": _rand((N, Lo), 300 + i) for i in range(3)}
    np.savez(tmp_path / "in.npz", **xs)
    (tmp_path / "spec.json").write_text(json.dumps({
        "priorities": [0, 10, -5], "sleep_s": 0.3, "wait_s": 30,
        "ports": [next_port()]}))
    t0 = time.monotonic()
    outs = _finish_pod(_start_pod("order", tmp_path, _clean_env(
        DMLC_NUM_WORKER="1", DMLC_NUM_SERVER="1",
        DMLC_PS_ROOT_URI="127.0.0.1", BYTEPS_FORCE_DISTRIBUTED="1",
        BYTEPS_PARTITION_BYTES="65536")), tmp_path, timeout=90)
    assert time.monotonic() - t0 < 90
    for i in range(3):
        want = xs[f"x{i}"][0] + xs[f"x{i}"][1]
        for o in outs:
            np.testing.assert_array_equal(o[f"r{i}"], want)


def test_failed_partition_fails_every_rank(tmp_path):
    """The controller's pushes of one partition fail past the stage's
    retries: the controller's call raises with the wire error, the other
    rank's with the status the tail carried, neither hangs, and the
    pod's next call still sums exactly."""
    Lf = 50000                  # 4 partitions of 65,536 bytes
    xs = {f"x{i}": _rand((N, Lf), 400 + i) for i in range(2)}
    np.savez(tmp_path / "in.npz", **xs)
    (tmp_path / "spec.json").write_text(json.dumps({
        "bad_key": 1, "wait_s": 30, "ports": [next_port()]}))
    outs = _finish_pod(_start_pod("fail", tmp_path, _clean_env(
        DMLC_NUM_WORKER="1", DMLC_NUM_SERVER="1",
        DMLC_PS_ROOT_URI="127.0.0.1", BYTEPS_FORCE_DISTRIBUTED="1",
        BYTEPS_PARTITION_BYTES="65536", BYTEPS_RETRY_LIMIT="0")),
        tmp_path, timeout=90)
    assert "injected push failure" in str(outs[0]["raised"])
    assert "failed on the pod controller" in str(outs[1]["raised"])
    for o in outs:
        np.testing.assert_array_equal(o["good"],
                                      xs["x1"][0] + xs["x1"][1])


# the owners legs: raw, then onebit + EF across a requested failover
OWNER_STEPS = [("g", None, False), ("g", None, False),
               ("c", {"compressor": "onebit", "ef": "vanilla"}, True),
               ("c", {"compressor": "onebit", "ef": "vanilla"}, True),
               ("c", {"compressor": "onebit", "ef": "vanilla"}, True),
               ("c", {"compressor": "onebit", "ef": "vanilla"}, True),
               ("g", None, False)]
OWNER_KILL = {"1": "push:kill@op=2.."}   # owner 1's NIC, in step 0
OWNER_FAIL_BEFORE = {"4": 2}             # owner 2, before step 4


def test_three_controller_pods_match_through_owner_failover(
        tmp_path, monkeypatch, port_server):
    """A reference pod and a port pod of three controller NICs each
    (``BYTEPS_POD_CONTROLLERS=3``, sharded) on one port server, holding
    the same rows. Owner 1's NIC is killed on both by the same plan (every
    push from its second wire op on; wire retries 1), and owner 2 is failed
    over on both before step 4, between onebit + EF steps. Every rank's
    result equals the reference pod's bit for bit at every step, and so
    does every payload the port controller pushes: the remapped
    partitions' error feedback restarts from zero on both (the same keys
    dropped); two failovers, owner 0 alone left, every credit pool full,
    the NICs' bytes summing to the reference's."""
    import byteps_tpu.jax as rbps
    from byteps_tpu.common.config import reset_config as r_reset
    from byteps_tpu.common.faults import FaultPlan as RPlan
    from byteps_tpu.common.faults import parse_fault_spec as rparse
    from byteps_tpu_torch.server import start_server_any_port

    Lo = 50000                  # 13 partitions of 16,384 bytes
    reference_lib()
    port = start_server_any_port(next_port(), num_workers=2)
    job_env(monkeypatch, port, workers=2)
    knobs = {"BYTEPS_HYBRID_SHARDED": "1", "BYTEPS_POD_CONTROLLERS": "3",
             "BYTEPS_PARTITION_BYTES": str(PARTITION_BYTES),
             "BYTEPS_MIN_COMPRESS_BYTES": "0", "BYTEPS_RETRY_LIMIT": "1",
             "BYTEPS_RETRY_BACKOFF_MS": "2"}
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    r_reset()
    xs = {f"x{i}": _rand((N, Lo), 500 + i) for i in range(len(OWNER_STEPS))}
    np.savez(tmp_path / "in.npz", **xs)
    (tmp_path / "spec.json").write_text(json.dumps({
        "steps": OWNER_STEPS, "kill": OWNER_KILL,
        "fail_before": OWNER_FAIL_BEFORE}))
    procs = _start_pod("mixed", tmp_path, _clean_env(
        DMLC_NUM_WORKER="2", DMLC_NUM_SERVER="1",
        DMLC_PS_ROOT_URI="127.0.0.1", DMLC_PS_ROOT_PORT=str(port - 1),
        DMLC_WORKER_ID="1", **knobs))
    mesh = jax.make_mesh((N,), ("dp",), devices=jax.devices()[:N])
    want, ref_pushes, ef = [], [], {}
    parts = -(-Lo * 4 // PARTITION_BYTES)
    try:
        t = threading.Thread(target=rbps.init, kwargs={"mesh": mesh})
        t.start()
        t.join(60)
        assert rbps._state.initialized
        workers = rbps._state.psworkers
        assert len(workers) == 3
        pushes = {}
        for w in workers:
            def recording(key, buf, *a, _push=w.push_bytes, **k):
                v = _push(key, buf, *a, **k)
                pushes[key] = np.array(buf, copy=True)
                return v

            w.push_bytes = recording
        for o, rule in OWNER_KILL.items():
            workers[int(o)]._plan = RPlan(
                rparse(rule), seed=rbps._state.cfg.fault_seed,
                worker_id=int(o))
        for i, (name, params, avg) in enumerate(OWNER_STEPS):
            if str(i) in OWNER_FAIL_BEFORE:
                ef["before"] = sorted(p for _, p in rbps._state.ef_state)
                assert rbps._fail_owner(OWNER_FAIL_BEFORE[str(i)])
                ef["after"] = sorted(p for _, p in rbps._state.ef_state)
            pushes.clear()
            box = []
            call = threading.Thread(target=lambda: box.append(rbps.push_pull(
                jnp.asarray(xs[f"x{i}"]), average=avg, name=name,
                compression_params=params)))
            call.start()
            end = time.monotonic() + 60
            while len(pushes) < parts and call.is_alive():
                assert time.monotonic() < end, f"step {i}: reference push"
                time.sleep(0.002)
            (tmp_path / f"go{i}").touch()    # now the port pod's pushes
            call.join(60)
            assert box, f"step {i} ({name}) gave no reference result"
            want.append(np.asarray(box[0]))
            ref_pushes.append(dict(pushes))
        ref_state = {"failovers": rbps._state.owner_failovers,
                     "live": sorted(rbps._state.owners.live()),
                     "nic_pushed": [w.bytes_pushed for w in workers]}
    finally:
        rbps.shutdown()
        rbps._state.__init__()
        r_reset()
        outs = _finish_pod(procs, tmp_path)
    for i, (name, params, avg) in enumerate(OWNER_STEPS):
        for o in outs:
            np.testing.assert_array_equal(o[f"r{i}"], want[i],
                                          err_msg=f"step {i}: {name}")
        got = {int(k.split("_")[1]): v for k, v in outs[0].items()
               if k.startswith(f"push{i}_")}
        assert sorted(got) == sorted(ref_pushes[i]) == list(range(
            min(got), min(got) + parts)), name
        for key, buf in ref_pushes[i].items():
            np.testing.assert_array_equal(got[key], buf,
                                          err_msg=f"step {i}: {name}")
    c = outs[0]
    # the moved partitions' residuals were dropped, the same on both
    assert list(c["ef_before4"]) == ef["before"] == list(range(parts))
    assert list(c["ef_after4"]) == ef["after"]
    assert 0 < len(ef["after"]) < parts
    assert int(c["owner_failovers"]) == ref_state["failovers"] == 2
    assert list(c["live_owners"]) == ref_state["live"] == [0]
    # the killed NIC's share depends on how the pool threads interleave
    # its first ops; the surviving NICs carry the rest, the same total
    assert sum(c["nic_pushed"]) == sum(ref_state["nic_pushed"])
    assert c["nic_pushed"][0] > 0 and c["nic_pushed"][2] > 0
    assert bool(c["credits_back"])
    x = xs["x0"]
    np.testing.assert_array_equal(want[0], 2 * (x[0] + x[1]))
