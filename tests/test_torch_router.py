"""The port's multi-replica router, fault plans in a replica and the
autoscaling policy, against the reference:

* replica death (``tests/test_serve.py``'s failover): a deterministic
  ``worker:kill@op=4`` on replica 1; the lease evicts it, the epoch is
  1, one eviction, the requeued count the reference's, every request's
  tokens the reference's (which equal solo), the survivor leak-free;
* the tenant fault scope (``tests/test_serve_multitenant.py``): the
  grammar, a ``tenant<T>:hang`` that defers one tenant's admission only,
  a ``tenant<T>:slow`` that slows one tenant's only — the same admission
  order, injections and tokens as the reference Scheduler's;
* ``ScalingPolicy`` (``tests/test_join.py``): the decision trace and its
  reasons on a recorded sample sequence, equal to the reference's;
  ``record_decision``'s counters and flight-recorder event; the router's
  autoscaling over stub replicas (the same admits, evicts and counters
  as the reference's router) and its lease eviction through the same
  decision path.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from byteps_tpu.common import metrics as jmetrics
from byteps_tpu.common.autoscaler import Sample as JSample
from byteps_tpu.common.autoscaler import ScalingPolicy as JScalingPolicy
from byteps_tpu.common.faults import FaultPlan as JFaultPlan
from byteps_tpu.common.faults import parse_fault_spec as j_parse
from byteps_tpu.common.faults import rules_to_spec as j_rules_to_spec
from byteps_tpu.models import GPTConfig as JConfig
from byteps_tpu.models.gpt import gpt_init as j_init
from byteps_tpu.serve import Request as JRequest
from byteps_tpu.serve import Router as JRouter
from byteps_tpu.serve import Scheduler as JScheduler
from byteps_tpu_torch.common.autoscaler import (
    Sample,
    ScalingPolicy,
    record_decision,
    serve_sample,
)
from byteps_tpu_torch.common.faults import (
    FaultPlan,
    WorkerKilledError,
    parse_fault_spec,
    rules_to_spec,
)
from byteps_tpu_torch.common.flight_recorder import (
    get_flight_recorder,
    reset_flight_recorder,
)
from byteps_tpu_torch.common.metrics import get_registry, reset_registry
from byteps_tpu_torch.models import (
    GPTConfig,
    make_generate_fn,
    params_from_numpy,
)
from byteps_tpu_torch.serve import (
    NoLiveReplicasError,
    Request,
    Router,
    Scheduler,
)

torch.set_num_threads(1)

JCFG, CFG = JConfig.tiny(), GPTConfig.tiny()


@pytest.fixture(autouse=True)
def _fresh_registry():
    reset_registry()
    reset_flight_recorder()
    yield
    reset_registry()
    reset_flight_recorder()


@pytest.fixture(scope="module")
def model():
    jp = j_init(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), CFG,
                                 device="cpu")


def _jcounters():
    return dict(jmetrics.get_registry().snapshot()["counters"])


def _counters():
    return get_registry().snapshot()["counters"]


def _solo(tp, prompt, n):
    return make_generate_fn(CFG, n, device="cpu")(tp, prompt[None]).numpy()[0]


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---- replica death: lease/epoch failover ------------------------------------
def test_replica_death_requeues_to_survivor(model):
    """``worker:kill@op=4`` at replica 1's fourth iteration: one lease
    eviction, epoch 1, the victim's requests requeued on the survivor
    (as many as the reference requeues), tokens exact, no leaks."""
    jp, tp = model
    rng = np.random.default_rng(29)
    reqs = []
    for i in range(6):
        T0 = [4, 9, 14, 6, 11, 5][i % 6]
        mn = [8, 5, 10][i % 3]
        reqs.append((f"r{i}", rng.integers(0, CFG.vocab_size, T0).astype(
            np.int32), mn))
    j0 = _jcounters()
    jr1 = JScheduler(jp, JCFG, max_batch=3, replica_id=1,
                     fault_plan=JFaultPlan(j_parse("worker:kill@op=4"),
                                           seed=0, worker_id=1))
    jrouter = JRouter([JScheduler(jp, JCFG, max_batch=3, replica_id=0), jr1],
                      lease_ms=50)
    jres = jrouter.run([JRequest(rid=r, prompt=p, max_new=n)
                        for r, p, n in reqs])
    j1 = _jcounters()
    plan = FaultPlan(parse_fault_spec("worker:kill@op=4"), seed=0,
                     worker_id=1)
    r0 = Scheduler(tp, CFG, max_batch=3, replica_id=0, device="cpu")
    r1 = Scheduler(tp, CFG, max_batch=3, replica_id=1, fault_plan=plan,
                   device="cpu")
    router = Router([r0, r1], lease_ms=50)
    res = router.run([Request(rid=r, prompt=p, max_new=n)
                      for r, p, n in reqs])
    for rid, prompt, n in reqs:
        np.testing.assert_array_equal(jres[rid]["tokens"],
                                      _solo(tp, prompt, n))
        np.testing.assert_array_equal(res[rid]["tokens"], jres[rid]["tokens"])
    assert router.epoch == jrouter.epoch == 1
    assert r1.dead and router.live_replicas() == [0]
    assert r0.cache.leaked_blocks() == 0
    moved = [r for r, _, _ in reqs if res[r]["replica"] == 0
             and res[r]["epoch"] == 1]
    assert moved
    c = _counters()
    for k in ("serve.router.evictions", "serve.router.requeued",
              "serve.resumed"):
        assert c.get(k, 0) == j1.get(k, 0) - j0.get(k, 0), k
    assert c["serve.router.evictions"] == 1
    assert c["serve.router.requeued"] >= 1
    assert c["autoscaler.serve.evict"] == 1
    ev = [e["event"] for e in get_flight_recorder().events()]
    assert "serve.replica_killed" in ev and "serve.replica_evicted" in ev
    with pytest.raises(WorkerKilledError):
        r1.step()


def test_router_refusals(model):
    _, tp = model
    with pytest.raises(ValueError, match="at least one replica"):
        Router([])
    pol = ScalingPolicy(scale_up_load=3.0, scale_down_load=0.5)
    r = Scheduler(tp, CFG, device="cpu")
    with pytest.raises(ValueError, match="spawn"):
        Router([r], policy=pol)
    with pytest.raises(ValueError, match="min_units"):
        Router([r], policy=ScalingPolicy(3.0, 0.5, min_units=0),
               spawn=lambda: r)
    router = Router([r])
    with pytest.raises(NoLiveReplicasError, match="last live"):
        router.drain_replica(0)


# ---- the tenant fault scope -------------------------------------------------
def test_tenant_fault_grammar_roundtrip():
    import random

    spec = "tenantt0:hang@op=1..4;tenantt1:slow@p=0.5,ms=40"
    rules = parse_fault_spec(spec)
    assert rules_to_spec(rules) == spec == j_rules_to_spec(j_parse(spec))
    assert [r.tenant for r in rules] == ["t0", "t1"]
    r = rules[0]
    assert r.matches("serve", -1, 2, random.Random(0), tenant="T0")
    assert not r.matches("serve", -1, 2, random.Random(0), tenant="t1")
    assert not r.matches("serve", -1, 2, random.Random(0))
    assert not r.matches("push", -1, 2, random.Random(0), tenant="t0")
    with pytest.raises(ValueError):
        parse_fault_spec("tenantt0:kill")
    with pytest.raises(ValueError):
        parse_fault_spec("tenant:hang")


def _tenant_run(sched_cls, params, cfg, plan, device):
    """Two tenants' requests, t0 queued first, on a fake clock: the
    admission order, the plan's injections, the results."""
    rng = np.random.default_rng(11)
    clock = _FakeClock()
    sched = sched_cls(params, cfg, max_batch=2, block_size=8, pool_blocks=40,
                      prefill_chunk=16, clock=clock, fault_plan=plan,
                      **device)
    order = []
    orig = sched._charge_admission

    def spy(run, reserve):
        order.append(run.req.rid)
        return orig(run, reserve)

    sched._charge_admission = spy
    req_cls = JRequest if sched_cls is JScheduler else Request
    prompts = {}
    for i, t in enumerate(["t0", "t1"]):
        prompts[t] = rng.integers(0, CFG.vocab_size, 6 + i).astype(np.int32)
        sched.submit(req_cls(rid=t, prompt=prompts[t], max_new=5, tenant=t))
    it = 0
    while not sched.finished:
        sched.step()
        clock.t += 0.005
        it += 1
        assert it < 5000
    return order, plan.counters(), sched.results, prompts


@pytest.mark.parametrize("spec", ["tenantt0:hang@op=1..4",
                                  "tenantt0:slow@op=1..3,ms=20"])
def test_tenant_rule_acts_on_one_tenant(model, spec):
    """A hang defers t0's admission, so t1 (queued behind it) admits
    first; a slow rule delays t0's admission ticks only. Order,
    injections and tokens equal the reference Scheduler's."""
    jp, tp = model
    ref = _tenant_run(JScheduler, jp, JCFG,
                      JFaultPlan(j_parse(spec), seed=0), {})
    port = _tenant_run(Scheduler, tp, CFG,
                       FaultPlan(parse_fault_spec(spec), seed=0),
                       {"device": "cpu"})
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    kind = spec.split(":")[1].split("@")[0]
    assert port[1][kind] >= 1
    if kind == "hang":
        assert port[0][0] == "t1" and "t0" in port[0]
    for t, prompt in port[3].items():
        np.testing.assert_array_equal(port[2][t]["tokens"],
                                      ref[2][t]["tokens"])
        np.testing.assert_array_equal(port[2][t]["tokens"],
                                      _solo(tp, prompt, 5))


def test_replica_hang_stalls_without_killing(model):
    """``replica:hang@op=2,ms=30`` stalls the second iteration, and the
    replica serves on exactly."""
    _, tp = model
    plan = FaultPlan(parse_fault_spec("replica:hang@op=2,ms=30"), seed=0)
    sched = Scheduler(tp, CFG, max_batch=2, fault_plan=plan, device="cpu")
    p = np.arange(5, dtype=np.int32)
    res = sched.serve([Request(rid="h", prompt=p, max_new=4)])
    assert plan.counters()["hang"] == 1 and not sched.dead
    np.testing.assert_array_equal(res["h"]["tokens"], _solo(tp, p, 4))


# ---- the autoscaling policy -------------------------------------------------
RECORDED = [
    (2, 0.9, 0.0), (2, 1.2, 0.0), (2, 1.15, 0.0), (3, 1.2, 0.0),
    (3, 1.2, 0.0), (3, 1.2, 0.0), (4, 1.2, 0.0), (4, 1.2, 0.0),
    (4, 1.2, 0.0), (4, 0.9, 6.0), (4, 0.9, 5.5), (3, 0.2, 0.0),
    (3, 0.2, 0.0), (3, 0.2, 0.0), (2, 0.9, 0.0),
]
POLICY = dict(scale_up_load=1.0, scale_down_load=0.3, straggler_limit=4.0,
              hysteresis=0.1, cooldown=2, sustain=2, min_units=1,
              max_units=4, domain="train")


def test_scaling_policy_trace_equals_reference():
    """The decision trace and its reasons on the reference test's
    recorded samples: admit on sustained headroom, evict on a straggler
    and on sustained idleness, hold in the band, the cooldown and at the
    bounds — each decision the reference's."""
    pol, jpol = ScalingPolicy(**POLICY), JScalingPolicy(**POLICY)
    for live, load, strag in RECORDED:
        pol.observe(Sample(live=live, load=load, straggler=strag))
        jpol.observe(JSample(live=live, load=load, straggler=strag))
    got = [(d.action, d.reason, d.step, d.live) for d in pol.trace]
    want = [(d.action, d.reason, d.step, d.live) for d in jpol.trace]
    assert got == want
    assert [a for a, *_ in got] == [
        "hold", "hold", "admit", "hold", "hold", "admit", "hold", "hold",
        "hold", "hold", "evict", "hold", "hold", "evict", "hold"]
    c = _counters()
    assert c["autoscaler.train.admit"] == 2
    assert c["autoscaler.train.evict"] == 2
    assert c["autoscaler.train.hold"] == 11
    with pytest.raises(ValueError, match="inverted band"):
        ScalingPolicy(scale_up_load=0.3, scale_down_load=0.9)


def test_estimator_veto_equals_reference():
    """An admit whose estimator predicts no payoff holds, says why, and
    is recorded; a linear estimator lets it through."""
    for est in (lambda n: 10.0, lambda n: 10.0 * n):
        kw = dict(scale_up_load=1.0, scale_down_load=0.3, hysteresis=0.1,
                  cooldown=0, sustain=1, min_units=1, max_units=4,
                  domain="serve", estimator=est)
        pol, jpol = ScalingPolicy(**kw), JScalingPolicy(**kw)
        d = pol.observe(Sample(live=2, load=2.0))
        jd = jpol.observe(JSample(live=2, load=2.0))
        assert (d.action, d.reason, d.predicted) == \
            (jd.action, jd.reason, jd.predicted)


def test_serve_sample_equals_reference():
    from byteps_tpu.common.autoscaler import serve_sample as j_serve_sample

    for args in ((3, 12, 0.0, None), (2, 5, 300.0, 100.0),
                 (0, 4, 50.0, 100.0)):
        assert dataclasses.astuple(serve_sample(*args)) == \
            dataclasses.astuple(j_serve_sample(*args))


def test_record_decision_shared_event_path():
    reg = get_registry()
    before = reg.counter("autoscaler.decisions").value()
    record_decision("train", "admit", "test join", target=7, live=3)
    assert reg.counter("autoscaler.decisions").value() == before + 1
    assert reg.counter("autoscaler.train.admit").value() == 1
    events = [e for e in get_flight_recorder().events()
              if e["event"] == "autoscaler.decision"]
    assert events and events[-1]["args"]["target"] == 7


# ---- the router's autoscaling over stub replicas ----------------------------
class _StubReplica:
    """A queue the router can balance, step, drain and collect from."""

    def __init__(self):
        self.queue = []
        self.results = {}

    @property
    def load(self):
        return len(self.queue)

    def submit(self, req, resume_tokens=None):
        self.queue.append(req)

    def step(self):
        if not self.queue:
            return False
        req = self.queue.pop(0)
        self.results[req.rid] = {"text": "ok"}
        return True

    def drain_incomplete(self):
        out = [(r, []) for r in self.queue]
        self.queue.clear()
        return out


@dataclasses.dataclass
class _Req:
    rid: int
    arrival_s: float = 0.0


def _autoscale_run(router_cls, policy_cls):
    pol = policy_cls(scale_up_load=3.0, scale_down_load=0.5,
                     hysteresis=0.0, cooldown=0, sustain=1, min_units=1,
                     max_units=3, domain="serve")
    router = router_cls([_StubReplica()], lease_ms=10_000_000, policy=pol,
                        spawn=_StubReplica)
    for i in range(12):
        router.submit(_Req(rid=i))
    live = [list(router.live_replicas())]
    for _ in range(40):
        router.step()
        live.append(list(router.live_replicas()))
        if router.live_replicas() == [0] and len(router.results) == 12:
            break
    return live, [d.action for d in pol.trace], router.epoch, \
        {r: res["replica"] for r, res in router.results.items()}


def test_router_replica_autoscaling_equals_reference():
    """Queue pressure spawns replicas, idleness drains them back to one:
    the same live sets step by step, decisions, epochs and placements as
    the reference's router, and the counters of the decision path."""
    port = _autoscale_run(Router, ScalingPolicy)
    j0 = _jcounters()
    ref = _autoscale_run(JRouter, JScalingPolicy)
    j1 = _jcounters()
    assert port == ref
    assert port[0][1] == [0, 1] and port[0][2] == [0, 1, 2]
    assert port[0][-1] == [0] and len(port[3]) == 12
    c = _counters()
    for k in ("autoscaler.serve.admit", "autoscaler.serve.evict",
              "autoscaler.decisions", "serve.router.requeued"):
        assert c.get(k, 0) == j1.get(k, 0) - j0.get(k, 0), k
    assert c["autoscaler.serve.admit"] == 2
    assert c["autoscaler.serve.evict"] >= 2


def test_router_lease_eviction_uses_shared_decision_path():
    """A replica whose step never completes ages out of its lease on the
    fake clock and is evicted through ``record_decision``."""
    def _killed():
        raise WorkerKilledError("injected replica death")

    now = [0.0]
    alive, dead = _StubReplica(), _StubReplica()
    dead.step = _killed
    router = Router([alive, dead], lease_ms=1000, clock=lambda: now[0])
    router.submit(_Req(rid=0))
    reg = get_registry()
    before = reg.counter("autoscaler.decisions").value()
    now[0] = 0.5
    router.step()
    assert len(router.live_replicas()) == 2
    for t in (1.2, 2.0):
        now[0] = t
        router.step()
    assert router.live_replicas() == [0]
    assert reg.counter("autoscaler.serve.evict").value() == 1
    assert reg.counter("autoscaler.decisions").value() == before + 1
    assert router.epoch == 1
