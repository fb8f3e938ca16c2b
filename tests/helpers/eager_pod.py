"""One rank of a port pod for ``tests/test_torch_hybrid.py``.

    python tests/helpers/eager_pod.py SCENARIO RANK WORLD DIR

joins a gloo group over a ``FileStore`` in DIR, runs the scenario with
``byteps_tpu_torch.eager`` on the CPU and saves its outputs to
``DIR/out<RANK>.npz``. The inputs are ``DIR/in.npz`` (each array stacked
by rank) and ``DIR/spec.json``; the ``DMLC_*`` / ``BYTEPS_*`` environment
is the caller's. Imports torch and the port only.

Scenarios:

* ``mixed`` — the port pod beside a reference pod on one server: step i
  waits for ``DIR/go<i>`` (the reference pod's pushes of it landed), then
  pushes and pulls; the controller records every payload it pushes,
  through each of its NICs. Optional in the spec: ``kill``, {owner: a
  fault spec} armed on that controller NIC alone at init;
  ``fail_before``, {step: owner} failed over on the controller just
  before the step (the partitions' error-feedback keys are recorded
  around it); then the controller's failover count, live owners,
  per-NIC bytes and credit pools.
* ``alone`` — one pod on its own servers (started here by rank 0, one a
  configuration), under each configuration of the spec (sharded or not,
  staged or ring tier): results, wire bytes against the plans', the
  stage count, and under the ring each compressed REDUCE beside the
  staged tier's on the same chunk.
* ``order`` — three tensors of different priorities, rank 1 sleeping
  between its calls, waited for in reverse order within a bound.
* ``fail`` — the controller's pushes of one partition raise: every
  rank's call fails, and the next call of the pod still sums.
* ``degraded`` — one pod on its own server, whose controller failed the
  server over before any push: each step degrades to the pod's sum
  (averaged over the pod), then a call with ``degraded_ok`` off fails on
  every rank; then the same rows through the eager ICI pipeline of the
  pod alone.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from byteps_tpu_torch import eager as bps
from byteps_tpu_torch.common.config import get_config, reset_config
from byteps_tpu_torch.common.faults import FaultPlan, parse_fault_spec
from byteps_tpu_torch.compression import from_params
from byteps_tpu_torch.compression.wire import make_wire_codec


def _wait_for(path: str, bound: float = 60.0) -> None:
    end = time.monotonic() + bound
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(f"{path} did not appear in {bound} s")
        time.sleep(0.005)


def _record_pushes(log: dict) -> None:
    """Record every payload the controller pushes, by key, into ``log``,
    through each of its NICs."""
    for w in bps._state.psworkers:
        def recording(key, buf, *a, _push=w.push_bytes, **k):
            log[key] = np.array(buf, copy=True)
            return _push(key, buf, *a, **k)

        w.push_bytes = recording


def mixed(rank, io, spec, d):
    out = {}
    bps.init()
    pushes = {}
    if rank == 0:
        _record_pushes(pushes)
        for owner, rule in spec.get("kill", {}).items():
            bps._state.psworkers[int(owner)]._plan = FaultPlan(
                parse_fault_spec(rule), seed=get_config().fault_seed,
                worker_id=int(owner))
    fail_before = {int(i): o for i, o in spec.get("fail_before", {}).items()}
    for i, (name, params, avg) in enumerate(spec["steps"]):
        _wait_for(f"{io}/go{i}")
        if rank == 0 and i in fail_before:
            out[f"ef_before{i}"] = np.array(sorted(
                p for _, p in bps._state.ef_state))
            assert bps._fail_owner(fail_before[i])
            out[f"ef_after{i}"] = np.array(sorted(
                p for _, p in bps._state.ef_state))
        pushes.clear()
        out[f"r{i}"] = bps.push_pull(torch.as_tensor(d[f"x{i}"][rank]),
                                     average=avg, name=name,
                                     compression_params=params).numpy()
        for key, buf in pushes.items():
            out[f"push{i}_{key}"] = buf
    if rank == 0:
        out["owner_failovers"] = np.array(bps._state.owner_failovers)
        out["live_owners"] = np.array(sorted(bps._state.owners.live()))
        out["nic_pushed"] = np.array([w.bytes_pushed
                                      for w in bps._state.psworkers])
        pools = bps._state.scheduler.credit_pools()
        out["credits_back"] = np.array(
            all(v == bps._state.cfg.scheduling_credit
                for v in pools.values()))
    bps.shutdown()
    return out


def _planned_bytes(name: str, params) -> int:
    """Bytes one call of ``name`` pushes (and pulls): each partition's
    codec bytes, raw f32 below BYTEPS_MIN_COMPRESS_BYTES."""
    codec = make_wire_codec(from_params(params))
    cfg = get_config()
    total = 0
    for p in bps._state.registry.get(name).partitions:
        total += (codec.wire_bytes(p.length)
                  if codec is not None and p.length * 4 >= cfg.min_compress_bytes
                  else p.length * 4)
    return total


def _compare_ring_reduce(log: list) -> None:
    """Under the ring tier, run each compressed REDUCE again on the staged
    tier, right after it (the caller's thread, the same order on every
    rank), and log both."""
    for fname in ("compressed_reduce_scatter_flat",
                  "compressed_allreduce_flat"):
        orig = getattr(bps, fname)

        def both(chunk, *a, _orig=orig, **k):
            ring = _orig(chunk, *a, **k)
            staged = _orig(chunk, *a, **{**k, "tier": "staged"})
            log.append((ring.numpy(), staged.numpy()))
            return ring

        setattr(bps, fname, both)


def _own_server(rank: int, port: int) -> None:
    """Rank 0 starts a one-pod server in its own process, on a free port
    from ``port`` on, and points the controller at it."""
    from byteps_tpu_torch.server import start_server_any_port

    if rank == 0:
        port = start_server_any_port(port, attempts=4, num_workers=1)
        os.environ["DMLC_PS_ROOT_PORT"] = str(port - 1)
    reset_config()


def _stop_own_server(rank: int) -> None:
    from byteps_tpu_torch.server import stop_server

    if rank == 0:
        stop_server()


def alone(rank, io, spec, d):
    out = {}
    for c, conf in enumerate(spec["configs"]):
        os.environ["BYTEPS_HYBRID_SHARDED"] = "1" if conf["sharded"] else "0"
        os.environ["BYTEPS_ICI_TIER"] = conf["tier"]
        _own_server(rank, spec["ports"][c])
        ring_log = []
        saved = {f: getattr(bps, f) for f in (
            "compressed_reduce_scatter_flat", "compressed_allreduce_flat")}
        if conf["tier"] == "ring":
            _compare_ring_reduce(ring_log)
        bps.init()
        out[f"c{c}_stages"] = np.array(len(bps._state.stages))
        want = 0
        for i, (name, params, avg) in enumerate(spec["steps"]):
            out[f"c{c}_r{i}"] = bps.push_pull(
                torch.as_tensor(d[f"x{i}"][rank]), average=avg, name=name,
                compression_params=params).numpy()
            want += _planned_bytes(name, params)
        out[f"c{c}_moved"] = np.array(bps.bytes_moved())
        out[f"c{c}_planned"] = np.array(want)
        for j, (ring, staged) in enumerate(ring_log):
            out[f"c{c}_ring{j}"], out[f"c{c}_staged{j}"] = ring, staged
        out[f"c{c}_ring_calls"] = np.array(len(ring_log))
        bps.shutdown()
        for f, fn in saved.items():
            setattr(bps, f, fn)
        _stop_own_server(rank)
    return out


def order(rank, io, spec, d):
    _own_server(rank, spec["ports"][0])
    bps.init()
    handles = []
    for i, prio in enumerate(spec["priorities"]):
        handles.append(bps.push_pull_async(torch.as_tensor(d[f"x{i}"][rank]),
                                           average=False, name=f"t{i}",
                                           priority=prio))
        if rank == 1:
            time.sleep(spec["sleep_s"])
    out = {}
    for i in reversed(range(len(handles))):
        out[f"r{i}"] = bps.synchronize(handles[i],
                                       timeout=spec["wait_s"]).numpy()
    bps.shutdown()
    _stop_own_server(rank)
    return out


def fail(rank, io, spec, d):
    _own_server(rank, spec["ports"][0])
    bps.init()
    if rank == 0:
        w = bps._state.psworker
        push = w.push_bytes

        def failing(key, *a, **k):
            if key == spec["bad_key"]:
                raise RuntimeError("injected push failure")
            return push(key, *a, **k)

        w.push_bytes = failing
    out = {"raised": np.array("")}
    try:
        bps.synchronize(bps.push_pull_async(torch.as_tensor(d["x0"][rank]),
                                            average=False, name="bad"),
                        timeout=spec["wait_s"])
    except Exception as e:  # noqa: BLE001 - the test reads the message
        out["raised"] = np.array(f"{type(e).__name__}: {e}")
    out["good"] = bps.synchronize(
        bps.push_pull_async(torch.as_tensor(d["x1"][rank]), average=False,
                            name="good"), timeout=spec["wait_s"]).numpy()
    bps.shutdown()
    _stop_own_server(rank)
    return out


def degraded(rank, io, spec, d):
    os.environ["BYTEPS_FORCE_DISTRIBUTED"] = "1"
    _own_server(rank, spec["ports"][0])
    bps.init()
    if rank == 0:
        bps._state.psworker.fail_over(0, barrier=False)
    out = {}
    for i, (name, params, avg) in enumerate(spec["steps"]):
        out[f"r{i}"] = bps.push_pull(torch.as_tensor(d[f"x{i}"][rank]),
                                     average=avg, name=name,
                                     compression_params=params).numpy()
    if rank == 0:
        out["fallbacks"] = np.array(
            bps._state.psworker.get_counters()["ici_fallbacks"])
    out["moved"] = np.array(bps.bytes_moved())
    bps._state.cfg.degraded_ok = False
    out["strict"] = np.array("")
    try:
        bps.synchronize(bps.push_pull_async(torch.as_tensor(d["x0"][rank]),
                                            name="strict"),
                        timeout=spec["wait_s"])
    except Exception as e:  # noqa: BLE001 - the test reads the message
        out["strict"] = np.array(f"{type(e).__name__}: {e}")
    bps.shutdown()
    _stop_own_server(rank)
    # the ICI result is the pod's alone, whatever the job's pod count
    os.environ["BYTEPS_FORCE_DISTRIBUTED"] = "0"
    os.environ["DMLC_NUM_WORKER"] = "1"
    reset_config()
    bps.init()
    for i, (name, params, avg) in enumerate(spec["steps"]):
        if params is None:
            out[f"e{i}"] = bps.push_pull(torch.as_tensor(d[f"x{i}"][rank]),
                                         average=avg, name=name).numpy()
    bps.shutdown()
    return out


def main() -> None:
    scenario, rank, world, io = (sys.argv[1], int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{io}/store",
                                                         world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    with open(f"{io}/spec.json") as f:
        spec = json.load(f)
    d = np.load(f"{io}/in.npz")
    out = {"mixed": mixed, "alone": alone, "order": order,
           "fail": fail, "degraded": degraded}[scenario](
        rank, io, spec, d)
    np.savez(f"{io}/out{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "ok": True}))


if __name__ == "__main__":
    main()
