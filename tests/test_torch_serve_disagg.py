"""Disaggregated prefill/decode and KV migration in the port, mirroring
``tests/test_serve_disagg.py`` case for case, each case run on the
reference's weights in both packages:

* the codec: a block round-trips byte for byte, dense, int8 and bf16
  (as its 16-bit words), the port's frame is byte-identical to the
  reference's, and each package decodes the other's; corruption and a
  layout mismatch are caught; the wire retries a corrupted delivery to a
  clean one;
* served requests: tokens equal to the reference's run of the same case
  (which equals solo ``make_generate_fn``) and to the port's solo run,
  and the ``serve.migration.*``, preemption and router counters equal to
  the reference's where the case fixes them (the wire's threads make the
  rest timing-dependent, and the port is held to the reference's bounds
  there); no KV block leaks on any pool; the prefill replica never builds
  the packed decode step, the decode replica never a prefill chunk;
* the replica fault scope's grammar and its targeting of one replica;
  the refusal of mismatched pool layouts.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from byteps_tpu.common import metrics as jmetrics
from byteps_tpu.common.faults import FaultPlan as JFaultPlan
from byteps_tpu.common.faults import parse_fault_spec as j_parse
from byteps_tpu.common.faults import rules_to_spec as j_rules_to_spec
from byteps_tpu.models import GPTConfig as JConfig
from byteps_tpu.models.gpt import gpt_init as j_init
from byteps_tpu.serve import Request as JRequest
from byteps_tpu.serve import Router as JRouter
from byteps_tpu.serve import Scheduler as JScheduler
from byteps_tpu.serve.kv_wire import BlockPayload as JBlockPayload
from byteps_tpu.serve.kv_wire import KVBlockCodec as JCodec
from byteps_tpu_torch.common.faults import (
    FaultPlan,
    WorkerKilledError,
    parse_fault_spec,
    rules_to_spec,
)
from byteps_tpu_torch.common.metrics import get_registry, reset_registry
from byteps_tpu_torch.models import (
    GPTConfig,
    make_generate_fn,
    params_from_numpy,
)
from byteps_tpu_torch.serve import PagedKVCache, Request, Router, Scheduler
from byteps_tpu_torch.serve.kv_wire import (
    BlockPayload,
    KVBlockCodec,
    KVWire,
    KVWireCorruption,
    KVWireError,
)

torch.set_num_threads(1)

JCFG, CFG = JConfig.tiny(), GPTConfig.tiny()


@pytest.fixture(autouse=True)
def _fresh_registry():
    reset_registry()
    yield
    reset_registry()


@pytest.fixture(scope="module")
def model():
    jp = j_init(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), CFG,
                                 device="cpu")


def _reqs(n, seed, prompt_lens=(9, 14, 6, 11), max_news=(8, 5, 10)):
    """``(rid, prompt, max_new)`` of the reference test's requests."""
    rng = np.random.default_rng(seed)
    return [(f"r{i}", rng.integers(0, CFG.vocab_size,
                                   prompt_lens[i % len(prompt_lens)]
                                   ).astype(np.int32),
             max_news[i % len(max_news)]) for i in range(n)]


def _jreqs(reqs):
    return [JRequest(rid=r, prompt=p, max_new=n) for r, p, n in reqs]


def _treqs(reqs):
    return [Request(rid=r, prompt=p, max_new=n) for r, p, n in reqs]


def _counters():
    return get_registry().snapshot()["counters"]


class _JDelta:
    """The reference registry's counter deltas over a block."""

    def __enter__(self):
        self.before = jmetrics.get_registry().snapshot()["counters"]
        return self

    def __exit__(self, *exc):
        after = jmetrics.get_registry().snapshot()["counters"]
        self.c = {k: v - self.before.get(k, 0) for k, v in after.items()}

    def get(self, k, default=0):
        return self.c.get(k, default)


def _run(router, reqs):
    try:
        return router.run(reqs)
    finally:
        router.close()


def _solo_check(tp, res, jres, reqs):
    """Port tokens equal to the reference's and to the port's solo run."""
    for rid, prompt, n in reqs:
        solo = make_generate_fn(CFG, n, device="cpu")(tp, prompt[None])
        np.testing.assert_array_equal(jres[rid]["tokens"], solo.numpy()[0],
                                      err_msg=rid)
        np.testing.assert_array_equal(res[rid]["tokens"], jres[rid]["tokens"],
                                      err_msg=rid)


def _same(port, ref, names):
    got = {k: port.get(k, 0) for k in names}
    want = {k: ref.get(k, 0) for k in names}
    assert got == want, (got, want)


# ---- the codec --------------------------------------------------------------
def _payloads(kind, rng, shape):
    """The same block as the port's and the reference's BlockPayload."""
    if kind == "int8":
        k, v = (rng.integers(-128, 128, shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.standard_normal(shape[:-1]).astype(np.float32)
                  for _ in range(2))
        return BlockPayload(k, v, ks, vs), JBlockPayload(k, v, ks, vs)
    if kind == "bf16":
        k, v = (torch.randn(shape).to(torch.bfloat16).view(torch.uint16)
                .numpy() for _ in range(2))
        return (BlockPayload(k, v),
                JBlockPayload(k.view(ml_dtypes.bfloat16),
                              v.view(ml_dtypes.bfloat16)))
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return BlockPayload(k, v), JBlockPayload(k, v)


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
def test_kv_codec_frames_byte_identical_to_reference(kind):
    rng = np.random.default_rng(3)
    shape = (3, 8, 2, 4)
    quant = kind == "int8"
    tdt = {"f32": torch.float32, "int8": torch.int8,
           "bf16": torch.bfloat16}[kind]
    jdt = {"f32": np.float32, "int8": np.int8,
           "bf16": ml_dtypes.bfloat16}[kind]
    codec = KVBlockCodec(3, 8, 2, 4, tdt, quant)
    jcodec = JCodec(3, 8, 2, 4, jdt, quant)
    p, jpay = _payloads(kind, rng, shape)
    buf = codec.encode(p)
    assert buf.nbytes == codec.frame_bytes == jcodec.frame_bytes
    np.testing.assert_array_equal(buf, jcodec.encode(jpay))
    for q in (codec.decode(buf), codec.decode(jcodec.encode(jpay))):
        for a, b in zip(p, q):
            if a is None:
                assert b is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    back = jcodec.decode(buf)
    for a, b in zip(jpay, back):
        if a is not None:
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    np.testing.assert_array_equal(buf, codec.encode(codec.decode(buf)))


def test_kv_codec_detects_corruption_and_mismatch():
    codec = KVBlockCodec(2, 4, 2, 4, np.float32, quant=False)
    p = BlockPayload(np.ones((2, 4, 2, 4), np.float32),
                     np.zeros((2, 4, 2, 4), np.float32))
    buf = codec.encode(p)
    bad = buf.copy()
    bad[40] ^= 0xFF                      # a body byte: the CRC trips
    with pytest.raises(KVWireCorruption):
        codec.decode(bad)
    assert KVWireCorruption.retryable and not KVWireError.retryable
    other = KVBlockCodec(2, 8, 2, 4, np.float32, quant=False)
    with pytest.raises(KVWireError):
        other.decode(buf)
    with pytest.raises(KVWireError):
        codec.decode(buf[:8])
    with pytest.raises(KVWireError, match="layout mismatch"):
        other.encode(p)


def test_kv_wire_corruption_retries_to_clean_delivery(model):
    """An injected corrupt flips a byte of the delivered frame: the CRC
    rejects it, the stage retry re-sends the pristine bytes, and the
    staged payload is exact — and the frames are the reference's."""
    jp, tp = model
    sched = Scheduler(tp, CFG, max_batch=2, block_size=4, device="cpu")
    sched.cache.register("w")
    sched.cache.ensure("w", 8)
    sched.cache.state.k.add_(1.0)
    payloads = sched.cache.snapshot_blocks("w", 0, 2)
    jsched = JScheduler(jp, JCFG, max_batch=2, block_size=4)
    jsched.cache.register("w")
    jsched.cache.ensure("w", 8)
    jsched.cache.state = jsched.cache.state._replace(
        k=jsched.cache.state.k.at[:].add(1.0))
    for bi, jpay in jsched.cache.snapshot_blocks("w", 0, 2).items():
        np.testing.assert_array_equal(sched.kv_codec.encode(payloads[bi]),
                                      jsched.kv_codec.encode(jpay))
    plan = FaultPlan(parse_fault_spec("push:corrupt@op=1"), seed=0)
    wire = KVWire(sched.kv_codec, resolve=lambda rid: sched, fault_plan=plan)
    try:
        for h in [wire.send_block("w", bi, p) for bi, p in payloads.items()]:
            h.wait(timeout=30)
        assert sched.staged_blocks("w") == {0, 1}
        staged = sched.pop_staged("w")
        for bi, p in payloads.items():
            np.testing.assert_array_equal(staged[bi].k, p.k)
            np.testing.assert_array_equal(staged[bi].v, p.v)
        assert plan.counters()["corrupt"] == 1
        assert _counters()["scheduler.stage_retries"] >= 1
        assert _counters()["serve.migration.blocks"] == 2
    finally:
        wire.shutdown()
        sched.cache.release("w")
    assert sched.cache.leaked_blocks() == 0


def test_kv_wires_stress_one_target_staging(model):
    """Eight wires (32 stage threads) push 64 distinct blocks into one
    target's staging at once under a short switch interval: every block
    staged exactly once with its own bytes, every handle done, every
    wire's in-flight gauge back at 0."""
    import sys

    _, tp = model
    sched = Scheduler(tp, CFG, max_batch=1, block_size=4, device="cpu")
    codec = sched.kv_codec
    rng = np.random.default_rng(41)
    shape = (codec.n_layers, codec.block_size, codec.h_kv, codec.head_dim)
    pays = {(w, b): BlockPayload(
        rng.standard_normal(shape).astype(np.float32),
        rng.standard_normal(shape).astype(np.float32))
        for w in range(8) for b in range(8)}
    wires = [KVWire(codec, resolve=lambda rid: sched) for _ in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        handles = [wires[w].send_block(f"rid{w}", b, p)
                   for (w, b), p in pays.items()]
        for h in handles:
            h.wait(timeout=60)
    finally:
        sys.setswitchinterval(old)
        for w in wires:
            w.shutdown()
    assert all(h.done() and not h.failed() for h in handles)
    for w in range(8):
        staged = sched.pop_staged(f"rid{w}")
        assert sorted(staged) == list(range(8))
        for b, got in staged.items():
            np.testing.assert_array_equal(got.k, pays[(w, b)].k)
            np.testing.assert_array_equal(got.v, pays[(w, b)].v)
    assert all(w._inflight == 0 for w in wires)
    assert _counters()["serve.migration.blocks"] == 64


def test_snapshot_and_write_payloads_move_bytes_verbatim():
    """A bf16 pool's blocks leave as raw 16-bit words and land bit for
    bit in another pool (one gather, one scatter a pool array), and an
    int8 pool's scales with them."""
    for dtype, quant in ((torch.bfloat16, False), (torch.float32, True)):
        cfg = GPTConfig(**{**CFG.__dict__, "dtype": dtype})
        src, dst = (PagedKVCache(cfg, block_size=4, pool_blocks=6,
                                 max_batch=1, quant=quant, device="cpu")
                    for _ in range(2))
        g = torch.Generator().manual_seed(1)
        for t in src.state:
            if t is not None:
                t.copy_(torch.randint(-100, 100, t.shape, generator=g)
                        if t.dtype == torch.int8 else
                        torch.randn(t.shape, generator=g))
        src.register("a")
        src.ensure("a", 12)
        pays = src.snapshot_blocks("a", 0, 3)
        if dtype == torch.bfloat16:
            assert pays[0].k.dtype == np.uint16
        dst.register("b")
        dst.ensure("b", 12)
        dst.write_payloads(dst._tables["b"], [pays[i] for i in range(3)])
        for ts, td in zip(src.state, dst.state):
            if ts is not None:
                assert torch.equal(ts[:, src._tables["a"]],
                                   td[:, dst._tables["b"]])
        assert dst.migrated_in_blocks == 3


# ---- the disaggregated smoke ----------------------------------------------
MIG = ("serve.migration.adopted", "serve.migration.in_requests",
       "serve.migration.blocks", "serve.migration.recompute_tokens")


@pytest.mark.parametrize("quant", [False, True])
def test_disagg_smoke_bit_exact_and_leak_free(model, quant):
    """One prefill and one decode replica, every request migrating
    (threshold 1): tokens equal to the reference's, the migration
    counters equal, no leaks, and the role split holds."""
    jp, tp = model
    reqs = _reqs(4, 7)
    kw = dict(max_batch=3, prefill_chunk=4, quant_cache=quant)
    with _JDelta() as jc:
        jpre = JScheduler(jp, JCFG, role="prefill", replica_id=1, **kw)
        jdec = JScheduler(jp, JCFG, role="decode", replica_id=0, **kw)
        jres = _run(JRouter([jdec], prefill_replicas=[jpre], lease_ms=5000,
                            prompt_threshold=1), _jreqs(reqs))
    pre = Scheduler(tp, CFG, role="prefill", replica_id=1, device="cpu", **kw)
    dec = Scheduler(tp, CFG, role="decode", replica_id=0, device="cpu", **kw)
    res = _run(Router([dec], prefill_replicas=[pre], lease_ms=5000,
                      prompt_threshold=1), _treqs(reqs))
    colo = Scheduler(tp, CFG, device="cpu", **kw).serve(_treqs(reqs))
    for rid, _, _ in reqs:
        np.testing.assert_array_equal(res[rid]["tokens"],
                                      jres[rid]["tokens"])
        np.testing.assert_array_equal(colo[rid]["tokens"],
                                      jres[rid]["tokens"])
        assert res[rid]["ttft_s"] is not None
    for s in (pre, dec):
        assert s.cache.leaked_blocks() == 0
        s.cache.check_refcounts()
    c = _counters()
    _same(c, jc, MIG + ("serve.migration.bytes",))
    assert c["serve.migration.adopted"] == len(reqs)
    assert c["serve.migration.recompute_tokens"] == 0
    assert pre._decode_fn is None and dec._prefill_fn is None
    assert dec.cache.migrated_in_blocks == jdec.cache.migrated_in_blocks > 0


def test_disagg_short_prompts_stay_on_decode_tier(model):
    """Prompts under the threshold prefill in place on the decode
    replica; long ones ride the prefill tier."""
    jp, tp = model
    rng = np.random.default_rng(11)
    short = ("s", rng.integers(0, CFG.vocab_size, 4).astype(np.int32), 4)
    long_ = ("l", rng.integers(0, CFG.vocab_size, 16).astype(np.int32), 4)
    kw = dict(max_batch=2, prefill_chunk=4)
    runs = {}
    for name, S, R, mk, cfg, p, dev in (
            ("ref", JScheduler, JRouter, _jreqs, JCFG, jp, {}),
            ("port", Scheduler, Router, _treqs, CFG, tp,
             {"device": "cpu"})):
        pre = S(p, cfg, role="prefill", replica_id=1, **kw, **dev)
        dec = S(p, cfg, replica_id=0, **kw, **dev)
        router = R([dec], prefill_replicas=[pre], lease_ms=5000,
                   prompt_threshold=10)
        with _JDelta() as jc:
            try:
                s, lg = mk([short, long_])
                assert router.submit(s) == 0      # the decode replica
                assert router.submit(lg) == 1     # the prefill replica
                while not router.finished(["s", "l"]):
                    router.step()
            finally:
                router.close()
        runs[name] = (router.results, jc if name == "ref" else _counters())
    _solo_check(tp, runs["port"][0], runs["ref"][0], [short, long_])
    _same(runs["port"][1], runs["ref"][1], MIG)
    assert runs["port"][1]["serve.migration.adopted"] == 1


# ---- migrate-don't-evict ----------------------------------------------------
def _pressure(jp, tp, migrate):
    """Replica A's tight pool under four 14-token prompts, replica B
    roomy (the reference test's case)."""
    rng = np.random.default_rng(13)
    reqs = [(f"m{i}", rng.integers(0, CFG.vocab_size, 14).astype(np.int32),
             10) for i in range(4)]
    kw = dict(max_batch=2, prefill_chunk=8, block_size=4)
    with _JDelta() as jc:
        ja = JScheduler(jp, JCFG, pool_blocks=1 + 10, replica_id=0, **kw)
        jb = JScheduler(jp, JCFG, replica_id=1, **kw)
        jres = _run(JRouter([ja, jb], lease_ms=5000,
                            migrate_preempt=migrate), _jreqs(reqs))
    a = Scheduler(tp, CFG, pool_blocks=1 + 10, replica_id=0, device="cpu",
                  **kw)
    b = Scheduler(tp, CFG, replica_id=1, device="cpu", **kw)
    res = _run(Router([a, b], lease_ms=5000, migrate_preempt=migrate),
               _treqs(reqs))
    _solo_check(tp, res, jres, reqs)
    assert a.cache.leaked_blocks() == 0 and b.cache.leaked_blocks() == 0
    return _counters(), jc


def test_migrate_dont_evict_zero_recompute(model):
    """With migration armed the victim's blocks move to B instead of
    being freed: no recompute, no classic preemption, the reference's
    migration counts."""
    c, jc = _pressure(*model, migrate=True)
    _same(c, jc, ("serve.migration.out_requests", "serve.migration.adopted",
                  "serve.migration.recompute_tokens", "serve.preempted",
                  "serve.migration.tokens"))
    assert c["serve.migration.out_requests"] >= 1
    assert c["serve.migration.recompute_tokens"] == 0
    assert c.get("serve.preempted", 0) == 0


def test_migrate_preempt_off_recomputes(model):
    """With migration off the same pressure evicts and recomputes: the
    reference's preemptions and recompute bill, tokens unchanged."""
    c, jc = _pressure(*model, migrate=False)
    _same(c, jc, ("serve.migration.out_requests", "serve.preempted",
                  "serve.migration.recompute_tokens"))
    assert c["serve.preempted"] >= 1
    assert c["serve.migration.recompute_tokens"] > 0


# ---- deterministic death (the replica<N> scope) -----------------------------
def test_decode_target_death_remaps_not_loses(model):
    """replica1:kill@op=1: the decode target dies before its first step
    while migrations are assigned to it; the lease evicts it, the wire's
    retries remap them to the survivor, and every request finishes
    exactly."""
    jp, tp = model
    reqs = _reqs(6, 17)
    kw = dict(max_batch=2, prefill_chunk=4)
    with _JDelta() as jc:
        jplan = JFaultPlan(j_parse("replica1:kill@op=1"), seed=0,
                           worker_id=1)
        jres = _run(JRouter(
            [JScheduler(jp, JCFG, replica_id=0, **kw),
             JScheduler(jp, JCFG, replica_id=1, fault_plan=jplan, **kw)],
            prefill_replicas=[JScheduler(jp, JCFG, role="prefill",
                                         replica_id=2, **kw)],
            lease_ms=50, prompt_threshold=1), _jreqs(reqs))
    plan = FaultPlan(parse_fault_spec("replica1:kill@op=1"), seed=0,
                     worker_id=1)
    pre = Scheduler(tp, CFG, role="prefill", replica_id=2, device="cpu", **kw)
    d0 = Scheduler(tp, CFG, replica_id=0, device="cpu", **kw)
    d1 = Scheduler(tp, CFG, replica_id=1, fault_plan=plan, device="cpu",
                   **kw)
    router = Router([d0, d1], prefill_replicas=[pre], lease_ms=50,
                    prompt_threshold=1)
    res = _run(router, _treqs(reqs))
    _solo_check(tp, res, jres, reqs)
    assert d1.dead and router.live_replicas() == [0, 2]
    assert d0.cache.leaked_blocks() == 0 and pre.cache.leaked_blocks() == 0
    c = _counters()
    _same(c, jc, ("serve.router.evictions", "serve.migration.adopted"))
    assert c["serve.router.evictions"] == 1
    assert c["serve.migration.retargets"] >= 1
    assert c["serve.migration.adopted"] == len(reqs)


def test_prefill_replica_death_degrades_to_colocated(model):
    """The only prefill replica dies mid-stream: its load re-classifies
    onto the decode replica, which prefills in place."""
    jp, tp = model
    reqs = _reqs(5, 19)
    with _JDelta() as jc:
        jplan = JFaultPlan(j_parse("replica2:kill@op=3"), seed=0,
                           worker_id=2)
        jres = _run(JRouter(
            [JScheduler(jp, JCFG, max_batch=3, prefill_chunk=4,
                        replica_id=0)],
            prefill_replicas=[JScheduler(jp, JCFG, max_batch=2,
                                         prefill_chunk=4, role="prefill",
                                         replica_id=2, fault_plan=jplan)],
            lease_ms=50, prompt_threshold=1), _jreqs(reqs))
    plan = FaultPlan(parse_fault_spec("replica2:kill@op=3"), seed=0,
                     worker_id=2)
    pre = Scheduler(tp, CFG, max_batch=2, prefill_chunk=4, role="prefill",
                    replica_id=2, fault_plan=plan, device="cpu")
    d0 = Scheduler(tp, CFG, max_batch=3, prefill_chunk=4, replica_id=0,
                   device="cpu")
    router = Router([d0], prefill_replicas=[pre], lease_ms=50,
                    prompt_threshold=1)
    res = _run(router, _treqs(reqs))
    _solo_check(tp, res, jres, reqs)
    assert pre.dead and router.live_replicas() == [0]
    assert d0.cache.leaked_blocks() == 0
    _same(_counters(), jc, ("serve.router.evictions",))
    assert _counters()["serve.router.evictions"] == 1


# ---- the replica<N> scope ---------------------------------------------------
def test_replica_scope_grammar_round_trip():
    spec = "replica2:kill@op=4;replica:slow@ms=20;replica1:hang@ms=5"
    rules = parse_fault_spec(spec)
    assert [r.scope for r in rules] == ["replica"] * 3
    assert rules[0].worker == 2 and rules[1].worker is None
    assert parse_fault_spec(rules_to_spec(rules)) == rules
    assert rules_to_spec(rules) == j_rules_to_spec(j_parse(spec))


def test_replica_scope_structured_errors():
    with pytest.raises(ValueError, match="replica<N>"):
        parse_fault_spec("replicaX:kill")
    for bad in ("replica1:corrupt@p=0.5", "replica1:join@step=3",
                "replica:timeout"):
        with pytest.raises(ValueError, match="kill|hang|slow"):
            parse_fault_spec(bad)


def test_replica_scope_targets_one_replica_only(model):
    """The same spec on every replica fires on the named one alone, at
    the reference's step, and never on wire ops."""
    jp, tp = model
    rules = parse_fault_spec("replica1:kill@op=2")
    r0 = Scheduler(tp, CFG, max_batch=2, replica_id=0, device="cpu",
                   fault_plan=FaultPlan(rules, seed=0, worker_id=0))
    r1 = Scheduler(tp, CFG, max_batch=2, replica_id=1, device="cpu",
                   fault_plan=FaultPlan(rules, seed=0, worker_id=1))
    reqs = _reqs(2, 23)
    res = r0.serve(_treqs(reqs))
    jres = JScheduler(jp, JCFG, max_batch=2, replica_id=0).serve(
        _jreqs(reqs))
    _solo_check(tp, res, jres, reqs)
    r1.submit(Request(rid="x", prompt=reqs[0][1], max_new=4))
    r1.step()
    with pytest.raises(WorkerKilledError):
        r1.step()
    assert r1.dead
    with pytest.raises(WorkerKilledError):
        r1.step()                        # sticky
    plan = FaultPlan(rules, seed=0, worker_id=1)
    assert plan.intercept("push", 0) is None
    assert plan.intercept("serve", -1) is not None


def test_router_rejects_mismatched_pool_layouts(model):
    _, tp = model
    pre = Scheduler(tp, CFG, block_size=16, role="prefill", replica_id=1,
                    device="cpu")
    dec = Scheduler(tp, CFG, block_size=4, replica_id=0, device="cpu")
    with pytest.raises(ValueError, match="pool layout"):
        Router([dec], prefill_replicas=[pre], prompt_threshold=1)
    q = Scheduler(tp, CFG, block_size=4, quant_cache=True, replica_id=2,
                  device="cpu")
    with pytest.raises(ValueError, match="pool layout"):
        Router([dec, q], migrate_preempt=True)
    Router([dec, q], migrate_preempt=False)
    with pytest.raises(ValueError, match="role='prefill'"):
        Router([dec], prefill_replicas=[q])


# ---- slow, as the reference marks them --------------------------------------
@pytest.mark.slow
def test_disagg_full_sweep(model):
    """2 prefill + 2 decode replicas, a paced wire, mixed lengths, a
    lookup request, quant off and on, migrate-preempt: every leg equal to
    the reference's and leak-free."""
    from byteps_tpu.serve.scheduler import SpecPolicy as JSpecPolicy
    from byteps_tpu_torch.serve import SpecPolicy

    jp, tp = model
    for quant in (False, True):
        reqs = _reqs(10, 29, prompt_lens=(14, 4, 18, 9), max_news=(8, 6))
        rng = np.random.default_rng(29)
        for _ in range(10):
            rng.integers(0, CFG.vocab_size, 1)
        base = np.random.default_rng(31).integers(
            0, CFG.vocab_size, 4).astype(np.int32)
        spec = ("spec", np.tile(base, 3)[:10], 8) if not quant else None
        runs = {}
        for name, S, R, Req, Pol, cfg, p, dev in (
                ("ref", JScheduler, JRouter, JRequest, JSpecPolicy, JCFG, jp,
                 {}),
                ("port", Scheduler, Router, Request, SpecPolicy, CFG, tp,
                 {"device": "cpu"})):
            kw = dict(max_batch=3, prefill_chunk=4, block_size=4,
                      quant_cache=quant, **dev)
            pre = [S(p, cfg, role="prefill", replica_id=10 + i, **kw)
                   for i in range(2)]
            dec = [S(p, cfg, pool_blocks=1 + 24, replica_id=i, **kw)
                   for i in range(2)]
            rs = [Req(rid=r, prompt=q, max_new=n) for r, q, n in reqs]
            if spec:
                rs.append(Req(rid=spec[0], prompt=spec[1], max_new=spec[2],
                              spec=Pol("lookup", spec_len=3)))
            runs[name] = _run(R(dec, prefill_replicas=pre, lease_ms=5000,
                                prompt_threshold=8, wire_mbps=200.0,
                                migrate_preempt=True), rs)
            if name == "port":
                for s in pre + dec:
                    assert s.cache.leaked_blocks() == 0
                    s.cache.check_refcounts()
        _solo_check(tp, runs["port"], runs["ref"],
                    reqs + ([spec] if spec else []))


@pytest.mark.slow
def test_prefix_sharing_survives_migration(model):
    """Two requests sharing a prompt prefix, migrated one after the
    other to one decode replica: the second adoption maps the shared
    blocks from the decode pool's index."""
    jp, tp = model
    rng = np.random.default_rng(31)
    shared = rng.integers(0, CFG.vocab_size, 12).astype(np.int32)
    reqs = [(f"p{i}", np.concatenate(
        [shared, rng.integers(0, CFG.vocab_size, 3).astype(np.int32)]), 5)
        for i in range(2)]
    kw = dict(max_batch=2, prefill_chunk=4, block_size=4)
    with _JDelta() as jc:
        jr = JRouter([JScheduler(jp, JCFG, replica_id=0, **kw)],
                     prefill_replicas=[JScheduler(jp, JCFG, role="prefill",
                                                  replica_id=1, **kw)],
                     lease_ms=5000, prompt_threshold=1)
        try:
            jres = dict(jr.run(_jreqs(reqs[:1])))
            jres.update(jr.run(_jreqs(reqs[1:])))
        finally:
            jr.close()
    pre = Scheduler(tp, CFG, role="prefill", replica_id=1, device="cpu", **kw)
    dec = Scheduler(tp, CFG, replica_id=0, device="cpu", **kw)
    router = Router([dec], prefill_replicas=[pre], lease_ms=5000,
                    prompt_threshold=1)
    try:
        res = dict(router.run(_treqs(reqs[:1])))
        res.update(router.run(_treqs(reqs[1:])))
    finally:
        router.close()
    _solo_check(tp, res, jres, reqs)
    c = _counters()
    _same(c, jc, ("serve.migration.adopted", "serve.prefix_saved_tokens"))
    assert c["serve.prefix_saved_tokens"] >= 12
    assert pre.cache.leaked_blocks() == 0 and dec.cache.leaked_blocks() == 0
    dec.cache.check_refcounts()
