"""Multi-tenant LoRA serving in the port (``serve/adapter_pool.py``, the
tenant plane of ``serve/scheduler.py``, the pooled arm of the packed
decode step), held against the reference's on the same numpy weights,
adapters and prompts (``tests/test_serve_multitenant.py``'s scenes).

Every tenant's greedy tokens out of the packed heterogeneous-adapter
batch equal a solo ``make_generate_fn`` run on its grafted tree, and the
reference Scheduler's; nothing leaks; fair queuing and quotas admit and
preempt as the reference does. One scene departs from the reference on
purpose: the prefix cache is keyed by adapter in the port, where the
reference lets a tenant adopt K/V pages another adapter computed and
then diverges from its own solo run (ROADMAP C)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models import GPTConfig as JConfig
from byteps_tpu.models.generate import make_generate_fn as j_make_generate
from byteps_tpu.models.gpt import gpt_init as j_init
from byteps_tpu.serve import AdapterPool as JPool
from byteps_tpu.serve import Request as JRequest
from byteps_tpu.serve import Scheduler as JScheduler
from byteps_tpu_torch.common import config as tconfig
from byteps_tpu_torch.common.metrics import get_registry, reset_registry
from byteps_tpu_torch.models import (
    GPTConfig,
    adapters_from_numpy,
    make_generate_fn,
    params_from_numpy,
)
from byteps_tpu_torch.serve import AdapterPool, Request, Scheduler

torch.set_num_threads(1)
CFG = GPTConfig.tiny()
JCFG = JConfig.tiny()


def np_adapter(seed, rank, targets=("wq", "wv"), b_scale=0.5):
    """A reference-shaped adapter of numpy arrays; b is NONZERO and large
    enough that every adapter changes the tiny model's tokens."""
    rng = np.random.default_rng(seed)
    return {"blocks": [
        {t: {"a": (rng.standard_normal((64, rank)) / rank ** 0.5
                   ).astype(np.float32),
             "b": (b_scale * rng.standard_normal((rank, 64))
                   ).astype(np.float32)}
         for t in targets}
        for _ in range(CFG.n_layers)]}


class Pools:
    """The reference's and the port's pool holding the same adapters."""

    def __init__(self, n_slots=4, rank_bucket=4, ranks=(2, 4, 1),
                 scales=(1.0, 1.5, 1.0), targets=("wq", "wv")):
        self.j = JPool(JCFG, n_slots=n_slots, rank_bucket=rank_bucket,
                       targets=targets)
        self.t = AdapterPool(CFG, n_slots=n_slots, rank_bucket=rank_bucket,
                             targets=targets, device="cpu")
        for i, (r, s) in enumerate(zip(ranks, scales)):
            ad = np_adapter(10 + i, r, targets)
            self.j.register(f"a{i}", jax.tree.map(jnp.asarray, ad), scale=s)
            self.t.register(f"a{i}", adapters_from_numpy(ad, device="cpu"),
                            scale=s)


@pytest.fixture(scope="module")
def weights():
    jp = j_init(jax.random.PRNGKey(0), JCFG)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    return jp, tp


@pytest.fixture(autouse=True)
def _fresh_registry():
    reset_registry()
    yield
    reset_registry()


def port_solo(tp, pool, req):
    tree = tp if req.adapter is None else pool.graft(tp, req.adapter)
    return make_generate_fn(CFG, req.max_new, device="cpu")(
        tree, np.asarray(req.prompt)[None]).numpy()[0]


def ref_solo(jp, pool, req):
    tree = jp if req.adapter is None else pool.graft(jp, req.adapter)
    return np.asarray(j_make_generate(JCFG, req.max_new)(
        tree, jnp.asarray(req.prompt)[None], jax.random.PRNGKey(0), 0.0))[0]


def jreq(r):
    return JRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                    tenant=r.tenant, adapter=r.adapter)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def drive(sched, clock, max_iters=5000):
    it = 0
    while not sched.finished:
        sched.step()
        clock.t += 0.005
        it += 1
        assert it < max_iters, "scheduler failed to drain"


def admission_order(sched):
    """Admission order, by wrapping the DWFQ charge (called once per
    admission)."""
    order = []
    orig = sched._charge_admission

    def spy(run, reserve):
        order.append(run.req.rid)
        return orig(run, reserve)

    sched._charge_admission = spy
    return order


def test_multitenant_bit_exact_vs_solo_and_reference(weights):
    """Mixed ranks (2/4/1), a scaled adapter and a base-model tenant in
    one continuous batch: every tenant's tokens equal its solo run on the
    grafted tree, the reference Scheduler's and the reference's solo run;
    no KV block or adapter slot leaks; the adapters end cached-idle."""
    jp, tp = weights
    pools = Pools()
    rng = np.random.default_rng(7)
    adapters = ["a0", "a1", "a2", None]
    reqs = [Request(rid=f"r{i}", prompt=rng.integers(
                0, CFG.vocab_size, [5, 9, 12, 7][i]).astype(np.int32),
                max_new=[8, 6, 9, 7][i], tenant=f"t{i}", adapter=aid)
            for i, aid in enumerate(adapters)]
    kw = dict(max_batch=4, block_size=8, pool_blocks=40, prefill_chunk=4)
    sched = Scheduler(tp, CFG, adapter_pool=pools.t, device="cpu", **kw)
    res = sched.serve(list(reqs))
    jres = JScheduler(jp, JCFG, adapter_pool=pools.j, **kw).serve(
        [jreq(r) for r in reqs])
    changed = 0
    for r in reqs:
        solo = port_solo(tp, pools.t, r)
        np.testing.assert_array_equal(res[r.rid]["tokens"], solo,
                                      err_msg=str(r.rid))
        np.testing.assert_array_equal(res[r.rid]["tokens"],
                                      jres[r.rid]["tokens"])
        np.testing.assert_array_equal(solo, ref_solo(jp, pools.j, r))
        changed += not np.array_equal(
            solo, port_solo(tp, pools.t, Request(r.rid, r.prompt, r.max_new)))
    assert changed == 3, "every adapter must change its tenant's tokens"
    assert sched.cache.leaked_blocks() == 0
    pools.t.check_refcounts()
    assert pools.t.leaked_slots() == 0
    assert pools.t.live_adapters == 0 and pools.t.cached_adapters == 3
    snap = get_registry().snapshot()
    for i, r in enumerate(reqs):
        assert snap["counters"][f"serve.tenantt{i}.admitted"] == 1
        assert snap["counters"][f"serve.tenantt{i}.tokens"] == r.max_new
        assert snap["histograms"][f"serve.tenantt{i}.ttft_ms"]["count"] == 1
    assert snap["counters"]["serve.adapter_loads"] == 3
    assert any(k.endswith(".cached_adapters") and v["value"] == 3
               for k, v in snap["gauges"].items())
    json.dumps(snap)


def test_pooled_decode_runs_the_segmented_delta(weights, monkeypatch):
    """The packed decode step adds the pooled deltas through
    ``segmented_lora_delta``: 2 targets × n_layers calls a step, the
    layer's strided slab slice and the step's slot vector each time."""
    from byteps_tpu_torch.serve import paged_cache

    _, tp = weights
    pools = Pools()
    calls = []
    real = paged_cache.segmented_lora_delta

    def spy(x, a, b, slots):
        calls.append((tuple(x.shape), a.is_contiguous(), slots.tolist()))
        return real(x, a, b, slots)

    monkeypatch.setattr(paged_cache, "segmented_lora_delta", spy)
    sched = Scheduler(tp, CFG, adapter_pool=pools.t, max_batch=3,
                      block_size=8, pool_blocks=40, prefill_chunk=16,
                      device="cpu")
    steps = []
    decode = sched._decode

    def count(*a):
        steps.append(a[-1].tolist())
        return decode(*a)

    sched._decode = count
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(0, 256, 6).astype(np.int32),
                    max_new=4, tenant=i, adapter=aid)
            for i, aid in enumerate(["a1", None])]
    sched.serve(reqs)
    assert len(calls) == 2 * CFG.n_layers * len(steps) and steps
    assert all(shape[0] == 3 and shape[1] == 1 and not contig
               for shape, contig, _ in calls)
    slot = pools.t.slot_of("a1")
    assert steps[0] == [slot, 0, 0] or steps[0] == [0, slot, 0]


def test_fair_queue_interleaves_flooder(weights):
    """Tenant a floods 4 requests before tenant b's 2: DWFQ admission
    (admit cap 1) interleaves a0 b0 a1 b1 a2 a3, as the reference does;
    the FIFO would be a0 a1 a2 a3 b0 b1."""
    jp, tp = weights
    orders = []
    for make in (lambda c: Scheduler(tp, CFG, device="cpu", clock=c, **KW1),
                 lambda c: JScheduler(jp, JCFG, clock=c, **KW1)):
        rng = np.random.default_rng(5)
        clock = FakeClock()
        sched = make(clock)
        orders.append(admission_order(sched))
        for t, n in (("a", 4), ("b", 2)):
            for k in range(n):
                kind = Request if isinstance(sched, Scheduler) else JRequest
                sched.submit(kind(rid=f"{t}{k}", prompt=rng.integers(
                    0, CFG.vocab_size, 6).astype(np.int32), max_new=4,
                    tenant=t))
        drive(sched, clock)
        assert sched.cache.leaked_blocks() == 0
    assert orders[0] == ["a0", "b0", "a1", "b1", "a2", "a3"]
    assert orders[0] == orders[1]


KW1 = dict(max_batch=1, block_size=8, pool_blocks=40, prefill_chunk=16)


def test_tenant_weights_scale_the_fair_share(weights):
    """Tenant b at weight 3 against a at 1, five requests each: b pays a
    third per admission, so it is admitted three times for a's once
    while both wait — the same order as the reference's."""
    jp, tp = weights
    orders = []
    for make in (lambda c: Scheduler(tp, CFG, device="cpu", clock=c,
                                     tenant_weights={"b": 3.0}, **KW1),
                 lambda c: JScheduler(jp, JCFG, clock=c,
                                      tenant_weights={"b": 3.0}, **KW1)):
        rng = np.random.default_rng(8)
        clock = FakeClock()
        sched = make(clock)
        orders.append(admission_order(sched))
        kind = Request if isinstance(sched, Scheduler) else JRequest
        for t in ("a", "b"):
            for k in range(5):
                sched.submit(kind(rid=f"{t}{k}", prompt=rng.integers(
                    0, CFG.vocab_size, 6).astype(np.int32), max_new=2,
                    tenant=t))
        drive(sched, clock)
    assert orders[0] == ["a0", "b0", "b1", "b2", "b3", "a1", "b4", "a2",
                         "a3", "a4"]
    assert orders[1] == orders[0]


@pytest.mark.parametrize("fair", [False, True], ids=["fifo", "one_tenant"])
def test_fifo_without_fair_queue_or_with_one_tenant(weights, fair):
    """Fair queuing off is FIFO; so is one tenant with it on (and
    untenanted traffic, the serve tier's own tests)."""
    _, tp = weights
    rng = np.random.default_rng(5)
    clock = FakeClock()
    sched = Scheduler(tp, CFG, device="cpu", clock=clock, fair_queue=fair,
                      **KW1)
    order = admission_order(sched)
    tenants = [("a", 3), ("b", 2)] if not fair else [("a", 5)]
    for t, n in tenants:
        for k in range(n):
            sched.submit(Request(rid=f"{t}{k}", prompt=rng.integers(
                0, CFG.vocab_size, 6).astype(np.int32), max_new=4, tenant=t))
    drive(sched, clock)
    assert order == [f"{t}{k}" for t, n in tenants for k in range(n)]


def test_quota_preempts_offender_not_sibling(weights):
    """Tenant A's two requests outgrow A's quota mid-decode: A's own
    youngest is preempted (and recomputed exactly), tenant B never is."""
    jp, tp = weights
    rng = np.random.default_rng(9)
    clock = FakeClock()
    sched = Scheduler(tp, CFG, max_batch=4, block_size=4, pool_blocks=24,
                      prefill_chunk=16, clock=clock, tenant_quota_blocks=4,
                      device="cpu")
    reqs = []
    for rid, t in (("A0", "A"), ("A1", "A"), ("B0", "B")):
        reqs.append(Request(rid=rid, prompt=rng.integers(
            0, CFG.vocab_size, 5).astype(np.int32), max_new=6, tenant=t))
        sched.submit(reqs[-1])
    drive(sched, clock)
    for r in reqs:
        np.testing.assert_array_equal(sched.results[r.rid]["tokens"],
                                      port_solo(tp, None, r))
        np.testing.assert_array_equal(sched.results[r.rid]["tokens"],
                                      ref_solo(jp, None, r))
    c = get_registry().snapshot()["counters"]
    assert c["serve.tenantA.quota_hits"] > 0
    assert c.get("serve.tenantB.quota_hits", 0) == 0
    assert c["serve.preempted"] > 0
    assert sched.results["A1"]["preemptions"] > 0
    assert sched.results["B0"]["preemptions"] == 0
    assert sched.cache.leaked_blocks() == 0


def test_quota_rejects_unrunnable_request_and_other_checks(weights):
    _, tp = weights
    sched = Scheduler(tp, CFG, max_batch=2, block_size=4, pool_blocks=24,
                      tenant_quota_blocks=2, device="cpu")
    with pytest.raises(ValueError, match="quota"):
        sched.submit(Request(rid="x", prompt=np.arange(5, dtype=np.int32),
                             max_new=8, tenant="A"))
    # untenanted requests are exempt (a quota isolates tenants)
    sched.submit(Request(rid="y", prompt=np.arange(5, dtype=np.int32),
                         max_new=8))
    with pytest.raises(ValueError, match="no adapter pool"):
        sched.submit(Request(rid="z", prompt=np.arange(5, dtype=np.int32),
                             max_new=2, adapter="a0"))
    pools = Pools()
    sched = Scheduler(tp, CFG, adapter_pool=pools.t, device="cpu")
    with pytest.raises(ValueError, match="not registered"):
        sched.submit(Request(rid="w", prompt=np.arange(5, dtype=np.int32),
                             max_new=2, adapter="nope"))
    with pytest.raises(ValueError, match="quota"):
        Scheduler(tp, CFG, tenant_quota_blocks=-1, device="cpu")
    with pytest.raises(ValueError, match="weight"):
        Scheduler(tp, CFG, tenant_weights={"a": 0.0}, device="cpu")


def test_tenant_knobs_from_the_environment(weights, monkeypatch):
    _, tp = weights
    monkeypatch.setenv("BYTEPS_SERVE_TENANT_QUOTA_BLOCKS", "7")
    monkeypatch.setenv("BYTEPS_SERVE_FAIR_QUEUE", "0")
    tconfig.reset_config()
    try:
        sched = Scheduler(tp, CFG, device="cpu")
        assert sched._quota == 7 and sched._fair is False
        monkeypatch.delenv("BYTEPS_SERVE_TENANT_QUOTA_BLOCKS")
        monkeypatch.delenv("BYTEPS_SERVE_FAIR_QUEUE")
        tconfig.reset_config()
        sched = Scheduler(tp, CFG, device="cpu")
        assert sched._quota == 0 and sched._fair is True
    finally:
        tconfig.reset_config()


def _same_prompt_two_tenants(weights, adapters):
    """Two tenants send one 40-token prompt, one after the other
    (max_batch 1, block 8): the second finds the first's committed
    prefix blocks."""
    jp, tp = weights
    pools = Pools(ranks=(4, 4), scales=(1.0, 1.0))
    prompt = np.random.default_rng(13).integers(
        0, CFG.vocab_size, 40).astype(np.int32)
    reqs = [Request(rid=f"r{i}", prompt=prompt, max_new=10, tenant=f"t{i}",
                    adapter=aid) for i, aid in enumerate(adapters)]
    kw = dict(max_batch=1, block_size=8, pool_blocks=40, prefill_chunk=16)
    sched = Scheduler(tp, CFG, adapter_pool=pools.t, device="cpu", **kw)
    res = sched.serve(list(reqs))
    hits = get_registry().snapshot()["counters"].get("serve.prefix_hits", 0)
    jres = JScheduler(jp, JCFG, adapter_pool=pools.j, **kw).serve(
        [jreq(r) for r in reqs])
    assert sched.cache.leaked_blocks() == 0
    return jp, tp, pools, reqs, res, jres, hits


def test_prefix_cache_never_crosses_adapters(weights):
    """Two tenants, one prompt, two adapters on wq/wv: the port's tokens
    equal each tenant's solo run and it counts no prefix hit; the
    reference adopts tenant a0's K/V pages for tenant a1 and a1's tokens
    differ from its own solo run (its index is keyed on tokens alone)."""
    jp, tp, pools, reqs, res, jres, hits = _same_prompt_two_tenants(
        weights, ["a0", "a1"])
    for r in reqs:
        solo = port_solo(tp, pools.t, r)
        np.testing.assert_array_equal(res[r.rid]["tokens"], solo)
        np.testing.assert_array_equal(solo, ref_solo(jp, pools.j, r))
    assert hits == 0
    np.testing.assert_array_equal(jres["r0"]["tokens"], res["r0"]["tokens"])
    assert not np.array_equal(jres["r1"]["tokens"],
                              ref_solo(jp, pools.j, reqs[1])), \
        "the reference no longer shares K/V across adapters"


def test_same_adapter_requests_share_prefix_pages(weights):
    jp, tp, pools, reqs, res, jres, hits = _same_prompt_two_tenants(
        weights, ["a1", "a1"])
    assert hits >= 1
    c = get_registry().snapshot()["counters"]
    assert c["serve.prefix_saved_tokens"] >= 32
    for r in reqs:
        np.testing.assert_array_equal(res[r.rid]["tokens"],
                                      port_solo(tp, pools.t, r))
        np.testing.assert_array_equal(res[r.rid]["tokens"],
                                      jres[r.rid]["tokens"])
