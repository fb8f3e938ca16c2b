"""The port's flight recorder (``byteps_tpu_torch/common/flight_recorder.py``)
beside the reference's: the per-step ring (``on_step``, ``tick``), the
post-mortem that rides every ``StallError`` and ``PartitionFailure``
(coalesced within a burst, one dump file a reason), ``metrics_snapshot``,
the train factories' tick a dispatched step — and ``train_sample``,
exactly the reference's on the same snapshot."""

import json
import threading
import time

import pytest
import torch

from byteps_tpu.common import autoscaler as rauto
from byteps_tpu.common import flight_recorder as rfr
from byteps_tpu.common import metrics as rmetrics
from byteps_tpu_torch import metrics_snapshot
from byteps_tpu_torch.common import autoscaler as tauto
from byteps_tpu_torch.common import config as tconfig
from byteps_tpu_torch.common import flight_recorder as tfr
from byteps_tpu_torch.common import metrics as tmetrics
from byteps_tpu_torch.common.partition import make_partitions
from byteps_tpu_torch.common.scheduler import (Handle, PartitionFailure,
                                               PartitionTask,
                                               PipelineScheduler, Stage,
                                               StallError)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh():
    tmetrics.reset_registry()
    tfr.reset_flight_recorder()
    tconfig.reset_config()
    yield
    tmetrics.reset_registry()
    tfr.reset_flight_recorder()
    tconfig.reset_config()


def _drive(fr, reg):
    """The same producer sequence against either package's recorder."""
    reg.counter("wire.push_bytes").inc(100)
    reg.histogram("scheduler.stage.PUSH.run_us").observe(50)
    reg.histogram("scheduler.stage.PUSH.dwell_us").observe(7)
    fr.on_step(3)
    fr.on_step(2)                    # behind: dropped
    fr.record_event("retry", {"key": 7})
    fr.tick()                        # relative: step 4
    reg.counter("wire.push_bytes").inc(50)
    fr.on_step(4)                    # idempotent
    fr.tick()                        # step 5


def test_step_ring_matches_the_reference():
    fr = tfr.FlightRecorder(max_steps=8, max_events=8)
    ref = rfr.FlightRecorder(max_steps=8, max_events=8)
    rmetrics.reset_registry()
    _drive(fr, tmetrics.get_registry())
    _drive(ref, rmetrics.get_registry())
    assert fr.summary() == ref.summary() == {
        "step": 5, "ring_steps": 3, "fault_events": 1}
    got, want = fr.steps(), ref.steps()
    assert [s["step"] for s in got] == [s["step"] for s in want] == [3, 4, 5]
    for g, w in zip(got, want):
        assert g["stages"] == w["stages"]
        assert g["counters"] == w["counters"]
        assert (g["step_ms"] is None) == (w["step_ms"] is None)
    assert [e["event"] for e in fr.events()] == ["retry"]
    assert fr.events()[0]["step"] == ref.events()[0]["step"] == 3
    assert tmetrics.get_registry().snapshot()["histograms"][
        "train.step_ms"]["count"] == 2
    rmetrics.reset_registry()


def test_zero_ring_still_times_steps():
    fr = tfr.FlightRecorder(max_steps=0, max_events=0)
    fr.record_event("x")
    for _ in range(3):
        fr.tick()
    assert fr.summary() == {"step": 3, "ring_steps": 0, "fault_events": 0}
    assert tmetrics.get_registry().snapshot()["histograms"][
        "train.step_ms"]["count"] == 2


def test_concurrent_ticks_never_swallow_a_step():
    fr = tfr.FlightRecorder(max_steps=1000)

    def ticker():
        for _ in range(50):
            fr.tick()

    ts = [threading.Thread(target=ticker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    steps = [s["step"] for s in fr.steps()]
    assert steps == list(range(1, 201))


def _one_stage(fn):
    """A one-stage pipeline and a handle of one enqueued partition."""
    sched = PipelineScheduler([Stage("PUSH", fn)], credit=2)
    h = Handle("grad", 1)
    sched.enqueue([PartitionTask(partition=p, name="grad", handle=h)
                   for p in make_partitions(0, 4, 4, 16)])
    return sched, h


def test_partition_failure_carries_a_post_mortem(tmp_path, monkeypatch):
    monkeypatch.setenv("BYTEPS_FLIGHT_RECORDER_DIR", str(tmp_path))
    tconfig.reset_config()
    tfr.get_flight_recorder().tick()

    def boom(task):
        raise ValueError("wire died")

    sched, h = _one_stage(boom)
    try:
        with pytest.raises(PartitionFailure) as ei:
            h.wait(timeout=10)
    finally:
        sched.shutdown()
    pm = ei.value.post_mortem
    assert pm["reason"] == "partition_failure" and pm["step"] == 1
    assert [e["event"] for e in pm["fault_events"]] == ["partition_failure"]
    assert pm["config"]["flight_recorder_dir"] == str(tmp_path)
    json.dumps(pm)
    deadline = time.monotonic() + 10
    files = []
    while not files and time.monotonic() < deadline:
        files = list(tmp_path.glob("flight_partition_failure_*.json"))
        time.sleep(0.01)
    assert len(files) == 1
    assert json.loads(files[0].read_text())["reason"] == "partition_failure"


def test_stall_post_mortem_coalesces_and_dumps_once(tmp_path, monkeypatch):
    monkeypatch.setenv("BYTEPS_FLIGHT_RECORDER_DIR", str(tmp_path))
    tconfig.reset_config()
    release = threading.Event()

    def slow(task):
        release.wait(10)
        return task

    sched, h = _one_stage(slow)
    try:
        errs = []
        for _ in range(3):
            with pytest.raises(StallError) as ei:
                h.wait(timeout=0.01)
            errs.append(ei.value)
        # one FAULT-ring event a handle, one shared dict in the burst
        assert errs[0].post_mortem is errs[1].post_mortem
        assert [e["event"] for e in errs[2].post_mortem["fault_events"]] \
            == ["stall"]
        assert len(list(tmp_path.glob("flight_stall_*.json"))) == 1
        fr = tfr.get_flight_recorder()
        manual = fr.post_mortem("stall", extra={"why": "probe"})
        assert manual is not errs[0].post_mortem   # extra: never cached
        assert len(list(tmp_path.glob("flight_stall_*.json"))) == 1
    finally:
        release.set()
        h.wait(timeout=10)
        sched.shutdown()


def test_train_factories_tick_once_a_step():
    from byteps_tpu_torch.models import (GPTConfig, ViTConfig,
                                         make_gpt_train_step,
                                         make_vit_train_step)

    cfg = GPTConfig.tiny()
    step, _, _ = make_gpt_train_step(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(1))
    for _ in range(3):
        step(toks[:, :-1], toks[:, 1:])
    vcfg = ViTConfig.tiny()
    vstep, _, _ = make_vit_train_step(
        vcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    vstep(torch.randn(2, vcfg.image_size, vcfg.image_size, vcfg.channels),
          torch.zeros(2, dtype=torch.long))
    snap = metrics_snapshot()
    json.dumps(snap)
    assert snap["flight_recorder"]["step"] == 4
    assert snap["flight_recorder"]["ring_steps"] == 4
    assert snap["metrics"]["histograms"]["train.step_ms"]["count"] == 3


def _snapshot(gauges, stale=None):
    m = {"counters": {}, "gauges": gauges, "histograms": {}}
    if stale is not None:
        m["histograms"]["server.staleness"] = {"count": 3, "p99": stale}
    return {"metrics": m, "flight_recorder": {}}


@pytest.mark.parametrize("snap,live,gp,base", [
    (_snapshot({}), 2, 10.0, 10.0),
    (_snapshot({"psworker.nic0.rounds_ahead": {"value": 3.0, "max": 3.0},
                "psworker.nic1.rounds_ahead": {"value": 1.0, "max": 2.0},
                "wire.push_bytes": {"value": 5.0, "max": 5.0}}),
     3, 7.5, 10.0),
    (_snapshot({"psworker.nic0.rounds_ahead": 4.0,
                "psworker.nic1.rounds_ahead": 0.5}, stale=6.0), 4, 1.0,
     0.0),
    ({"counters": {}, "gauges": {"psworker.a.rounds_ahead": 2.0},
      "histograms": {"server.staleness": {"p99": None}}}, 1, 3.0, 2.0),
])
def test_train_sample_equals_the_reference(snap, live, gp, base):
    got = tauto.train_sample(snap, live, gp, base)
    want = rauto.train_sample(snap, live, gp, base)
    assert (got.live, got.load, got.straggler) == (
        want.live, want.load, want.straggler)


def test_train_sample_from_a_live_snapshot():
    reg = tmetrics.get_registry()
    reg.gauge("psworker.nic0.rounds_ahead").set(2)
    reg.gauge("psworker.nic1.rounds_ahead").set(5)
    snap = json.loads(json.dumps(metrics_snapshot()))
    s = tauto.train_sample(snap, 2, 9.0, 10.0)
    r = rauto.train_sample(snap, 2, 9.0, 10.0)
    assert (s.live, s.load, s.straggler) == (r.live, r.load, r.straggler) \
        == (2, 0.9, 3.0)
