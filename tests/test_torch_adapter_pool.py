"""The port's adapter slot pool (``byteps_tpu_torch/serve/adapter_pool.py``):
the reference's pool tests (``tests/test_serve_multitenant.py:100-199``)
rewritten for the port, and one seeded schedule of register, acquire,
release, prefetch, evict and unregister driven through the reference's
pool and the port's side by side: the same slots, the same slab
contents, the same counters and gauges after every op."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.common.metrics import get_registry as j_registry
from byteps_tpu.models import GPTConfig as JConfig
from byteps_tpu.serve import AdapterPool as JPool
from byteps_tpu.serve.paged_cache import PoolExhausted as JExhausted
from byteps_tpu_torch.common import config as tconfig
from byteps_tpu_torch.common.metrics import get_registry, reset_registry
from byteps_tpu_torch.models import GPTConfig, adapters_from_numpy
from byteps_tpu_torch.models.gpt import gpt_init
from byteps_tpu_torch.serve import AdapterPool, PoolExhausted

torch.set_num_threads(1)
CFG = GPTConfig.tiny()
JCFG = JConfig.tiny()
COUNTERS = ("serve.adapter_loads", "serve.adapter_evictions",
            "serve.adapter_alloc_failures")


def np_adapter(seed, rank, targets=("wq", "wv")):
    rng = np.random.default_rng(seed)
    return {"blocks": [
        {t: {"a": rng.standard_normal((64, rank)).astype(np.float32),
             "b": (0.02 * rng.standard_normal((rank, 64))).astype(np.float32)}
         for t in targets}
        for _ in range(CFG.n_layers)]}


def mk_adapter(seed, rank, targets=("wq", "wv")):
    return adapters_from_numpy(np_adapter(seed, rank, targets), device="cpu")


def mk_pool(n_slots=4, rank_bucket=4, ranks=(2, 4, 1),
            scales=(1.0, 1.5, 1.0)):
    pool = AdapterPool(CFG, n_slots=n_slots, rank_bucket=rank_bucket,
                       device="cpu")
    for i, (r, s) in enumerate(zip(ranks, scales)):
        pool.register(f"a{i}", mk_adapter(10 + i, r), scale=s)
    return pool


@pytest.fixture(autouse=True)
def _fresh_registry():
    reset_registry()
    yield
    reset_registry()


def test_pool_slot_lifecycle_and_lru():
    pool = mk_pool(n_slots=3)                     # 2 allocatable slots
    s0 = pool.acquire("a0", "r0")
    assert s0 != 0 and pool.resident("a0") and pool.live_adapters == 1
    assert pool.acquire("a0", "r1") == s0         # a second holder
    pool.release("a0", "r0")
    assert pool.live_adapters == 1                # r1 still pins it
    pool.release("a0", "r1")
    assert pool.live_adapters == 0 and pool.cached_adapters == 1
    assert pool.resident("a0") and pool.slot_of("a0") == s0
    # fill the other slot, then a third adapter LRU-evicts idle a0
    pool.acquire("a1", "r2")
    pool.acquire("a2", "r3")
    assert not pool.resident("a0")
    pool.check_refcounts()
    # prefetch never evicts: no free slot, a1/a2 live -> miss
    assert pool.prefetch("a0") is False
    pool.release("a1", "r2")
    pool.release("a2", "r3")
    assert pool.leaked_slots() == 0
    c = get_registry().snapshot()["counters"]
    assert c["serve.adapter_loads"] == 3
    assert c["serve.adapter_evictions"] == 1


def test_pool_loads_the_padded_scaled_slabs_in_place():
    pool = mk_pool(n_slots=3)
    a_before = pool.slabs["wq"]["a"]
    slot = pool.acquire("a1", "r0")                # rank 4, scale 1.5
    assert pool.slabs["wq"]["a"] is a_before       # written in place
    ad = mk_adapter(11, 4)
    for li in range(CFG.n_layers):
        assert torch.equal(pool.slabs["wv"]["a"][slot, li],
                           ad["blocks"][li]["wv"]["a"])
        assert torch.equal(pool.slabs["wv"]["b"][slot, li],
                           ad["blocks"][li]["wv"]["b"] * 1.5)
    assert (pool.slabs["wq"]["a"][0] == 0).all()   # the zero slot stays 0
    graft = pool.graft(gpt_init(CFG, device="cpu"), "a1")
    assert torch.equal(graft["blocks"][1]["lora"]["wv"]["b"],
                       pool.slabs["wv"]["b"][slot, 1])


def test_pool_exhausted_occupancy_breakdown():
    pool = mk_pool(n_slots=3)
    pool.acquire("a0", "r0")
    pool.acquire("a1", "r1")
    with pytest.raises(PoolExhausted) as ei:
        pool.acquire("a2", "r2")
    msg = str(ei.value)
    assert "'a2' needs a slot" in msg and "0 free" in msg
    assert "2 allocatable = 2 live adapter(s) + 0 cached-idle" in msg
    # the failed acquire changed nothing (all-or-nothing)
    pool.check_refcounts()
    assert pool.live_adapters == 2 and pool.leaked_slots() == 0
    assert get_registry().snapshot()["counters"][
        "serve.adapter_alloc_failures"] == 1


def test_pool_validation():
    with pytest.raises(ValueError):
        AdapterPool(CFG, n_slots=1, rank_bucket=4, device="cpu")
    with pytest.raises(ValueError):
        AdapterPool(CFG, n_slots=3, rank_bucket=0, device="cpu")
    pool = mk_pool()
    with pytest.raises(ValueError):               # rank > bucket
        pool.register("big", mk_adapter(99, 8))
    with pytest.raises(ValueError):               # missing a pool target
        pool.register("wq_only", mk_adapter(98, 2, ("wq",)))
    with pytest.raises(ValueError):               # registered twice
        pool.register("a0", mk_adapter(97, 2))
    with pytest.raises(KeyError):
        pool.acquire("nope", "r0")
    pool.acquire("a0", "r0")
    with pytest.raises(ValueError):               # double pin
        pool.acquire("a0", "r0")
    with pytest.raises(ValueError):               # live -> no unregister
        pool.unregister("a0")
    with pytest.raises(ValueError):               # live -> no evict
        pool.evict_idle("a0")
    pool.release("a0", "r0")
    with pytest.raises(ValueError):               # unknown holder
        pool.release("a0", "r0")
    assert pool.rank_of("a1") == 4
    pool.unregister("a0")
    assert not pool.registered("a0") and not pool.resident("a0")


def test_pool_sizes_from_the_environment(monkeypatch):
    monkeypatch.setenv("BYTEPS_SERVE_ADAPTER_SLOTS", "5")
    monkeypatch.setenv("BYTEPS_SERVE_ADAPTER_RANK_BUCKET", "16")
    tconfig.reset_config()
    try:
        pool = AdapterPool(CFG, device="cpu")
        assert pool.n_slots == 5 and pool.rank_bucket == 16
        assert pool.slabs["wv"]["b"].shape == (5, CFG.n_layers, 16, 64)
        monkeypatch.delenv("BYTEPS_SERVE_ADAPTER_SLOTS")
        tconfig.reset_config()
        with pytest.raises(ValueError, match="n_slots"):
            AdapterPool(CFG, device="cpu")         # default 0: off
    finally:
        tconfig.reset_config()


def test_pool_randomized_schedule_never_leaks():
    """400 random acquire/release/prefetch/evict/churn ops against a
    tight pool; the refcount and slot-partition invariants hold after
    every op."""
    rng = np.random.default_rng(7)
    pool = mk_pool(n_slots=4)
    for i in range(3, 6):                          # 6 adapters, 3 slots
        pool.register(f"a{i}", mk_adapter(20 + i, 1 + i % 4))
    holders = {f"a{i}": set() for i in range(6)}   # shadow ground truth
    hseq = 0
    for step in range(400):
        aid = f"a{rng.integers(0, 6)}"
        op = rng.integers(0, 10)
        if op < 4:                                 # acquire a new holder
            if not pool.registered(aid):
                pool.register(aid, mk_adapter(40 + hseq, 2))
            h = f"h{hseq}"
            hseq += 1
            try:
                slot = pool.acquire(aid, h)
                assert 0 < slot < pool.n_slots
                holders[aid].add(h)
            except PoolExhausted:
                assert pool.free_slots == 0 and pool.cached_adapters == 0
        elif op < 8:                               # release one holder
            if holders[aid]:
                h = sorted(holders[aid])[0]
                pool.release(aid, h)
                holders[aid].remove(h)
        elif op == 8:                              # prefetch (free-only)
            if pool.registered(aid):
                pool.prefetch(aid)
        else:                                      # churn: evict/unregister
            if pool.registered(aid) and not holders[aid]:
                if pool.resident(aid):
                    pool.evict_idle(aid)
                else:
                    pool.unregister(aid)
        pool.check_refcounts()
        assert pool.leaked_slots() == 0, f"leak at op {step}"
    assert pool.live_adapters == sum(1 for hs in holders.values() if hs)


def _counters(snap, base):
    return {k: snap.get(k, 0) - base.get(k, 0) for k in COUNTERS}


def test_pool_matches_reference_pool_op_for_op():
    """One seeded schedule through both pools: every op returns the same
    slot (or raises in both), and after it the residency, slab contents,
    counters and gauges agree."""
    rng = np.random.default_rng(11)
    jpool = JPool(JCFG, n_slots=4, rank_bucket=4, targets=("wq", "wv"))
    tpool = AdapterPool(CFG, n_slots=4, rank_bucket=4, device="cpu")
    j0 = dict(j_registry().snapshot()["counters"])
    t0 = dict(get_registry().snapshot()["counters"])
    holders = {}
    for step in range(300):
        aid = f"a{rng.integers(0, 6)}"
        op = rng.integers(0, 10)
        res = []
        for pool, exhausted in ((jpool, JExhausted), (tpool, PoolExhausted)):
            if op < 4:
                if not pool.registered(aid):
                    ad = np_adapter(100 + step, 1 + step % 4)
                    scale = 1.0 + (step % 3) * 0.5
                    pool.register(aid, jax.tree.map(jnp.asarray, ad)
                                  if pool is jpool else
                                  adapters_from_numpy(ad, device="cpu"),
                                  scale=scale)
                try:
                    res.append(pool.acquire(aid, f"h{step}"))
                except exhausted:
                    res.append("exhausted")
            elif op < 8:
                hs = holders.get(aid)
                if hs:
                    pool.release(aid, min(hs))
                res.append(None)
            elif op == 8:
                res.append(pool.registered(aid) and pool.prefetch(aid))
            else:
                if pool.registered(aid) and not holders.get(aid):
                    if pool.resident(aid):
                        pool.evict_idle(aid)
                    else:
                        pool.unregister(aid)
                res.append(None)
        assert res[0] == res[1], (step, res)
        if op < 4 and res[0] != "exhausted":
            holders.setdefault(aid, set()).add(f"h{step}")
        elif 4 <= op < 8 and holders.get(aid):
            holders[aid].remove(min(holders[aid]))
        tpool.check_refcounts()
        assert tpool._slot == jpool._slot, step
        assert (tpool.live_adapters, tpool.cached_adapters,
                tpool.free_slots) == (jpool.live_adapters,
                                      jpool.cached_adapters,
                                      jpool.free_slots)
        assert (tpool._g_live.value(), tpool._g_cached.value()) == \
            (jpool._g_live.value(), jpool._g_cached.value())
        assert _counters(get_registry().snapshot()["counters"], t0) == \
            _counters(j_registry().snapshot()["counters"], j0)
        for slot in tpool._slot.values():
            for t in ("wq", "wv"):
                for k in ("a", "b"):
                    np.testing.assert_array_equal(
                        tpool.slabs[t][k][slot].numpy(),
                        np.asarray(jpool.slabs[t][k][slot]))
    assert _counters(get_registry().snapshot()["counters"], t0)[
        "serve.adapter_loads"] > 10
