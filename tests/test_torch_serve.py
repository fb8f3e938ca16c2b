"""The port's continuous-batching serve tier, mirroring
``tests/test_serve.py``: every request served out of the paged pool —
batched with strangers, chunk-prefilled, preempted and resumed, on an
int8 pool, or through a prefix-cache hit — emits tokens equal to the
port's solo ``make_generate_fn`` run AND to the reference's solo run on
the same weights; zero KV blocks leak at drain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models import GPTConfig as JConfig
from byteps_tpu.models.generate import make_generate_fn as j_make_generate
from byteps_tpu.models.gpt import gpt_init as j_init
from byteps_tpu_torch.common.metrics import get_registry, reset_registry
from byteps_tpu_torch.models import GPTConfig, params_from_numpy
from byteps_tpu_torch.models.generate import make_generate_fn
from byteps_tpu_torch.serve import (
    NoProgressError,
    PagedKVCache,
    PoolExhausted,
    Request,
    Scheduler,
)

torch.set_num_threads(1)

CFG = GPTConfig.tiny()
JCFG = JConfig.tiny()
_LLAMA = dict(vocab_size=256, max_seq=64, d_model=64, n_heads=4,
              n_kv_heads=2, n_layers=2, d_ff=128)


@pytest.fixture(autouse=True)
def _fresh_registry():
    reset_registry()
    yield
    reset_registry()


class _Model:
    """Reference and port weights of one config, with cached solo runs."""

    def __init__(self, jcfg, tcfg):
        self.jcfg, self.tcfg = jcfg, tcfg
        self.jp = j_init(jax.random.PRNGKey(0), jcfg)
        self.tp = params_from_numpy(jax.tree.map(np.asarray, self.jp), tcfg,
                                    device="cpu")
        self._jgen, self._tgen = {}, {}

    def solo(self, req, quant=False):
        """(port solo tokens, reference solo tokens) of ``req`` alone."""
        key = (req.max_new, quant)
        if key not in self._jgen:
            self._jgen[key] = j_make_generate(self.jcfg, req.max_new,
                                              quant_cache=quant)
            self._tgen[key] = make_generate_fn(self.tcfg, req.max_new,
                                               quant_cache=quant,
                                               device="cpu")
        prompt = np.asarray(req.prompt)[None]
        port = self._tgen[key](self.tp, prompt).numpy()[0]
        ref = np.asarray(self._jgen[key](self.jp, jnp.asarray(prompt),
                                         jax.random.PRNGKey(0), 0.0))[0]
        return port, ref

    def check(self, res, reqs, quant=False):
        for r in reqs:
            port, ref = self.solo(r, quant)
            np.testing.assert_array_equal(port, ref, err_msg=str(r.rid))
            np.testing.assert_array_equal(res[r.rid]["tokens"], port,
                                          err_msg=str(r.rid))


@pytest.fixture(scope="module")
def gpt2():
    return _Model(JCFG, CFG)


@pytest.fixture(scope="module")
def llama():
    return _Model(JConfig.llama(**_LLAMA), GPTConfig.llama(**_LLAMA))


def _mk_requests(n, rng, arrival=None):
    reqs = []
    for i in range(n):
        T0 = [4, 9, 14, 6, 11, 5][i % 6]
        mn = [8, 5, 10][i % 3]
        prompt = rng.integers(0, CFG.vocab_size, T0).astype(np.int32)
        reqs.append(Request(rid=f"r{i}", prompt=prompt, max_new=mn,
                            arrival_s=arrival[i] if arrival else 0.0))
    return reqs


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _drive(sched, clock, max_iters=5000):
    it = 0
    while not sched.finished:
        sched.step()
        clock.t += 0.005
        it += 1
        assert it < max_iters, "scheduler failed to drain"


def test_paged_cache_alloc_free_defrag():
    cache = PagedKVCache(CFG, block_size=8, pool_blocks=9, max_batch=2,
                         device="cpu")
    assert cache.free_blocks == 8          # block 0 reserved for scratch
    cache.register("a")
    cache.register("b")
    cache.ensure("a", 17)                  # 3 blocks
    cache.ensure("b", 8)                   # 1 block
    assert cache.blocks_in_use == 4 and cache.free_blocks == 4
    assert 0 not in cache.table_row("a")[:3]
    with pytest.raises(PoolExhausted):    # all or nothing
        cache.ensure("b", 8 * 6)
    assert cache.blocks_in_use == 4
    cache.release("a")
    assert cache.free_blocks == 7 and cache.leaked_blocks() == 0
    cache.ensure("b", 24)
    cache.state.k[:, cache.table_row("b")[:3]] = torch.arange(
        3, dtype=cache.state.k.dtype)[None, :, None, None, None]
    before = [cache.state.k[:, b].clone() for b in cache.table_row("b")[:3]]
    cache.defrag()
    row = cache.table_row("b")[:3]
    assert sorted(row) == [1, 2, 3], row
    for x, b in zip(before, row):
        torch.testing.assert_close(cache.state.k[:, b], x)
    assert cache.leaked_blocks() == 0
    cache.check_refcounts()
    with pytest.raises(ValueError):
        cache.register("b")


def test_submit_validation(gpt2):
    sched = Scheduler(gpt2.tp, CFG, max_batch=2, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        sched.submit(Request(rid="too-long",
                             prompt=np.arange(10, dtype=np.int32),
                             max_new=CFG.max_seq))
    with pytest.raises(ValueError, match="max_new"):
        sched.submit(Request(rid="no-new", prompt=np.arange(4, dtype=np.int32),
                             max_new=0))
    with pytest.raises(ValueError, match="live on"):
        Scheduler(gpt2.tp, CFG, device="meta")


def test_serve_exact_mixed_lengths_continuous(gpt2):
    """6 mixed-length requests admitted continuously (staggered arrivals
    on a virtual clock, fewer slots than requests): tokens equal the
    solo runs, no leaks, the serve.* series saw the traffic."""
    rng = np.random.default_rng(7)
    clock = _FakeClock()
    reqs = _mk_requests(6, rng, arrival=[0.0, 0.0, 0.02, 0.05, 0.08, 0.12])
    sched = Scheduler(gpt2.tp, CFG, max_batch=3, prefill_chunk=8,
                      clock=clock, device="cpu")
    for r in reqs:
        sched.submit(r)
    _drive(sched, clock)
    gpt2.check(sched.results, reqs)
    assert sched.cache.leaked_blocks() == 0
    assert (sched.cache.free_blocks + sched.cache.prefix_blocks
            == sched.cache.pool_blocks - 1)
    snap = get_registry().snapshot()
    assert snap["counters"]["serve.admitted"] == 6
    assert snap["counters"]["serve.completed"] == 6
    assert snap["histograms"]["serve.ttft_ms"]["count"] == 6
    assert snap["counters"]["serve.decode_tokens"] > 0
    for r in reqs:
        res = sched.results[r.rid]
        assert res["ttft_s"] is not None and res["total_s"] >= 0


def test_prefill_chunking_exact(gpt2):
    rng = np.random.default_rng(11)
    reqs = [Request(rid="long0", prompt=rng.integers(
                0, CFG.vocab_size, 21).astype(np.int32), max_new=8),
            Request(rid="long1", prompt=rng.integers(
                0, CFG.vocab_size, 17).astype(np.int32), max_new=6)]
    sched = Scheduler(gpt2.tp, CFG, max_batch=2, prefill_chunk=4,
                      device="cpu")
    gpt2.check(sched.serve(reqs), reqs)
    assert sched.cache.leaked_blocks() == 0


def test_preemption_recompute_on_resume_exact(gpt2):
    rng = np.random.default_rng(13)
    reqs = [Request(rid=f"p{i}", prompt=rng.integers(
                0, CFG.vocab_size, 14).astype(np.int32), max_new=10)
            for i in range(2)]
    sched = Scheduler(gpt2.tp, CFG, max_batch=2, prefill_chunk=8,
                      block_size=4, pool_blocks=1 + 9, device="cpu")
    res = sched.serve(reqs)
    gpt2.check(res, reqs)
    assert sum(res[r.rid]["preemptions"] for r in reqs) > 0, \
        "pool was large enough that preemption never engaged"
    assert sched.cache.leaked_blocks() == 0
    snap = get_registry().snapshot()["counters"]
    assert snap["serve.preempted"] > 0
    assert snap["serve.migration.recompute_tokens"] > 0


def test_quant_pool_matches_quant_solo(gpt2):
    rng = np.random.default_rng(17)
    reqs = _mk_requests(4, rng)
    sched = Scheduler(gpt2.tp, CFG, max_batch=4, quant_cache=True,
                      device="cpu")
    gpt2.check(sched.serve(reqs), reqs, quant=True)
    assert sched.cache.leaked_blocks() == 0


def test_prefix_hit_skips_shared_blocks(gpt2):
    """The second of two requests sharing a 12-token prefix maps the
    shared blocks from the radix index and never prefills them; outputs
    equal a cold (prefix-off) run and the solo runs."""
    rng = np.random.default_rng(31)
    shared = rng.integers(0, CFG.vocab_size, 12).astype(np.int32)
    reqs = [Request(rid=f"pc{i}", prompt=np.concatenate(
                [shared, rng.integers(0, CFG.vocab_size, 3).astype(
                    np.int32)]), max_new=6) for i in range(2)]
    sched = Scheduler(gpt2.tp, CFG, max_batch=2, prefill_chunk=4,
                      block_size=4, device="cpu")
    res = {}
    for r in reqs:                       # sequential: #2 sees #1's commits
        res.update(sched.serve([r]))
    snap = get_registry().snapshot()["counters"]
    gpt2.check(res, reqs)
    cold = Scheduler(gpt2.tp, CFG, max_batch=2, prefill_chunk=4,
                     block_size=4, prefix_cache=False, device="cpu")
    cold_res = cold.serve([Request(rid="cold", prompt=reqs[1].prompt,
                                   max_new=6)])
    np.testing.assert_array_equal(res[reqs[1].rid]["tokens"],
                                  cold_res["cold"]["tokens"])
    assert snap["serve.prefix_hits"] >= 1
    assert snap["serve.prefix_saved_tokens"] >= 12
    assert snap["serve.prefill_tokens"] == \
        sum(len(r.prompt) for r in reqs) - snap["serve.prefix_saved_tokens"]
    assert snap["serve.prefix_misses"] == 1
    sched.cache.check_refcounts()
    assert sched.cache.leaked_blocks() == 0
    assert (sched.cache.free_blocks + sched.cache.prefix_blocks
            == sched.cache.pool_blocks - 1)
    held = sched.cache.prefix_blocks
    assert held > 0 and sched.cache.drop_prefix_cache() == held
    assert sched.cache.free_blocks == sched.cache.pool_blocks - 1


def test_eos_stops_the_request(gpt2):
    rng = np.random.default_rng(43)
    prompt = rng.integers(0, CFG.vocab_size, 7).astype(np.int32)
    solo, _ = gpt2.solo(Request(rid="e", prompt=prompt, max_new=8))
    gen = solo[len(prompt):]
    eos = int(gen[2])
    stop = int(np.flatnonzero(gen == eos)[0])       # first emission of eos
    res = Scheduler(gpt2.tp, CFG, max_batch=2, device="cpu").serve(
        [Request(rid="e", prompt=prompt, max_new=8, eos_id=eos)])
    np.testing.assert_array_equal(res["e"]["emitted"], gen[:stop + 1])


@pytest.mark.parametrize("quant", [False, True])
def test_llama_gqa_pool_exact(llama, quant):
    """GQA pool (kv heads only), rope at per-row positions, swiglu and
    rmsnorm through the packed decode step."""
    rng = np.random.default_rng(37)
    reqs = _mk_requests(3, rng)
    sched = Scheduler(llama.tp, llama.tcfg, max_batch=2, prefill_chunk=5,
                      quant_cache=quant, device="cpu")
    assert sched.cache.state.k.shape[-2] == 2
    llama.check(sched.serve(reqs), reqs, quant=quant)
    assert sched.cache.leaked_blocks() == 0


def test_sampled_requests_are_batch_invariant(gpt2):
    """A sampled request draws per (seed, position): served alone or
    beside others, it emits the same tokens."""
    rng = np.random.default_rng(41)
    prompt = rng.integers(0, CFG.vocab_size, 6).astype(np.int32)
    mk = lambda rid: Request(rid=rid, prompt=prompt, max_new=8,  # noqa: E731
                             temperature=0.9, seed=5)
    alone = Scheduler(gpt2.tp, CFG, max_batch=4, device="cpu").serve(
        [mk("s")])["s"]["tokens"]
    others = _mk_requests(3, rng)
    mixed = Scheduler(gpt2.tp, CFG, max_batch=4, device="cpu").serve(
        others + [mk("s")])["s"]["tokens"]
    np.testing.assert_array_equal(alone, mixed)


def test_no_progress_raises(gpt2):
    sched = Scheduler(gpt2.tp, CFG, max_batch=1, device="cpu")
    sched.step = lambda: False
    with pytest.raises(NoProgressError):
        sched.serve([Request(rid="x", prompt=np.arange(3, dtype=np.int32),
                             max_new=2)], max_idle_iters=5)
