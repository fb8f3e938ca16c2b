"""The port's speculative decoding against the reference's, mirroring
``tests/test_speculative.py`` and ``tests/test_serve.py``'s speculative
lane: on the reference's weights (``params_from_numpy``) and prompts,
every sampler's tokens equal the reference's **and** its ``rounds`` is
the same integer, whatever the draft: a random draft at spec_len 1, 3
and 4, the draft equal to the target (the round ceiling), a shallower
draft with narrower kv, the llama options, prompt lookup (a random and
a tiled prompt), and over tp2 on two gloo ranks against the reference in
``shard_map``. The reference's refusals are the port's, with their
messages. The scheduler's lane serves the reference's requests: tokens,
each result's ``spec_rounds`` and the ``serve.spec_rounds``,
``serve.spec_tokens`` and ``serve.decode_tokens`` counters equal to the
reference Scheduler's, and no KV block leaks."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from pp_moe_parity import j_mesh, port_groups, tree_leaves  # noqa: E402

from byteps_tpu.common import metrics as jmetrics  # noqa: E402
from byteps_tpu.models import GPTConfig as JConfig  # noqa: E402
from byteps_tpu.models import gpt_param_specs as j_gpt_specs  # noqa: E402
from byteps_tpu.models.gpt import gpt_init as j_init  # noqa: E402
from byteps_tpu.models.speculative import (  # noqa: E402
    make_lookup_generate_fn as j_lookup,
    make_speculative_generate_fn as j_spec,
)
from byteps_tpu.serve import Request as JRequest  # noqa: E402
from byteps_tpu.serve import Scheduler as JScheduler  # noqa: E402
from byteps_tpu.serve import SpecPolicy as JSpecPolicy  # noqa: E402
from byteps_tpu_torch.common.metrics import (  # noqa: E402
    get_registry,
    reset_registry,
)
from byteps_tpu_torch.models import (  # noqa: E402
    GPTConfig,
    make_generate_fn,
    make_lookup_generate_fn,
    make_speculative_generate_fn,
    params_from_numpy,
)
from byteps_tpu_torch.serve import Request, Scheduler, SpecPolicy  # noqa: E402

torch.set_num_threads(1)

JCFG, CFG = JConfig.tiny(), GPTConfig.tiny()
MAX_NEW = 12
_LLAMA = dict(vocab_size=256, max_seq=64, d_model=64, n_heads=4,
              n_kv_heads=2, n_layers=2, d_ff=128)
SPEC_COUNTERS = ("serve.spec_rounds", "serve.spec_tokens",
                 "serve.decode_tokens")


@pytest.fixture(autouse=True)
def _fresh_registry():
    reset_registry()
    yield
    reset_registry()


def _weights(jcfg, tcfg, seed):
    jp = j_init(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")


@pytest.fixture(scope="module")
def model():
    jp, tp = _weights(JCFG, CFG, 0)
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                           JCFG.vocab_size))
    return jp, tp, prompt


def _both_spec(jcfg, tcfg, djcfg, dtcfg, jp, tp, jd, td, prompt, max_new,
               spec_len):
    """(reference tokens, rounds), (port tokens, rounds) of the draft
    sampler."""
    jo, jr = j_spec(jcfg, djcfg, max_new=max_new, spec_len=spec_len)(
        jp, jd, jnp.asarray(prompt))
    to, tr = make_speculative_generate_fn(tcfg, dtcfg, max_new=max_new,
                                          spec_len=spec_len,
                                          device="cpu")(tp, td, prompt)
    return (np.asarray(jo), int(jr)), (to.numpy(), tr)


def _plain(tcfg, tp, prompt, max_new):
    return make_generate_fn(tcfg, max_new, device="cpu")(tp, prompt).numpy()


def _check(ref, port, plain):
    np.testing.assert_array_equal(ref[0], plain)
    np.testing.assert_array_equal(port[0], ref[0])
    assert isinstance(port[1], int) and port[1] == ref[1], (port[1], ref[1])


@pytest.mark.parametrize("spec_len", [1, 3, 4])
def test_exact_vs_plain_greedy_random_draft(model, spec_len):
    """A draft the target disagrees with changes no token, and the port
    takes the reference's verify rounds."""
    jp, tp, prompt = model
    jd, td = _weights(JCFG, CFG, 9)
    ref, port = _both_spec(JCFG, CFG, JCFG, CFG, jp, tp, jd, td, prompt,
                           MAX_NEW, spec_len)
    _check(ref, port, _plain(CFG, tp, prompt, MAX_NEW))
    assert port[1] <= MAX_NEW


def test_self_draft_hits_the_round_ceiling(model):
    """draft == target accepts everything: ceil((max_new - 1) / 4) + 1
    verify forwards at most."""
    jp, tp, prompt = model
    ref, port = _both_spec(JCFG, CFG, JCFG, CFG, jp, tp, jp, tp, prompt,
                           MAX_NEW, 4)
    _check(ref, port, _plain(CFG, tp, prompt, MAX_NEW))
    assert port[1] <= -(-(MAX_NEW - 1) // 4) + 1, port[1]


def test_smaller_draft_model(model):
    """A shallower draft with narrower kv (the deployment shape)."""
    jp, tp, prompt = model
    djcfg = dataclasses.replace(JCFG, n_layers=1, n_kv_heads=2)
    dtcfg = dataclasses.replace(CFG, n_layers=1, n_kv_heads=2)
    jd, td = _weights(djcfg, dtcfg, 3)
    ref, port = _both_spec(JCFG, CFG, djcfg, dtcfg, jp, tp, jd, td, prompt,
                           MAX_NEW, 3)
    _check(ref, port, _plain(CFG, tp, prompt, MAX_NEW))


def test_llama_options_compose():
    """rope, GQA, swiglu, rmsnorm and the untied readout through the
    shared cached step."""
    jcfg, tcfg = JConfig.llama(**_LLAMA), GPTConfig.llama(**_LLAMA)
    jp, tp = _weights(jcfg, tcfg, 4)
    jd, td = _weights(jcfg, tcfg, 7)
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (2, 6), 0,
                                           jcfg.vocab_size))
    ref, port = _both_spec(jcfg, tcfg, jcfg, tcfg, jp, tp, jd, td, prompt,
                           8, 3)
    _check(ref, port, _plain(tcfg, tp, prompt, 8))


@pytest.mark.parametrize("tiled", [False, True])
def test_lookup_draft_exact_and_accelerates(model, tiled):
    """Prompt lookup: plain greedy's tokens, the reference's rounds, and
    fewer rounds than tokens (tiny random models fall into greedy loops;
    a tiled prompt repeats from the start)."""
    jp, tp, prompt = model
    if tiled:
        prompt = np.tile(prompt[:, :4], (1, 4))
    max_new = 32
    jo, jr = j_lookup(JCFG, max_new=max_new, spec_len=4)(
        jp, jnp.asarray(prompt))
    to, tr = make_lookup_generate_fn(CFG, max_new=max_new, spec_len=4,
                                     device="cpu")(tp, prompt)
    _check((np.asarray(jo), int(jr)), (to.numpy(), tr),
           _plain(CFG, tp, prompt, max_new))
    assert tr < max_new, tr


def test_lookup_validation(model):
    _, tp, _ = model
    gen = make_lookup_generate_fn(CFG, max_new=4, device="cpu")
    with pytest.raises(ValueError, match="bigram"):
        gen(tp, np.zeros((1, 1), np.int32))
    with pytest.raises(ValueError, match="spec_len"):
        make_lookup_generate_fn(CFG, max_new=4, spec_len=0, device="cpu")
    gen = make_lookup_generate_fn(CFG, max_new=CFG.max_seq, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        gen(tp, np.zeros((1, 8), np.int32))


def test_validation(model):
    _, tp, _ = model
    with pytest.raises(ValueError, match="spec_len"):
        make_speculative_generate_fn(CFG, CFG, max_new=4, spec_len=0,
                                     device="cpu")
    bad = dataclasses.replace(CFG, vocab_size=128)
    with pytest.raises(ValueError, match="vocab"):
        make_speculative_generate_fn(CFG, bad, max_new=4, device="cpu")
    gen = make_speculative_generate_fn(CFG, CFG, max_new=CFG.max_seq,
                                       spec_len=4, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        gen(tp, tp, np.zeros((1, 8), np.int32))
    short = dataclasses.replace(CFG, max_seq=16)
    gen = make_speculative_generate_fn(CFG, short, max_new=8, spec_len=4,
                                       device="cpu")
    with pytest.raises(ValueError, match="draft max_seq"):
        gen(tp, tp, np.zeros((1, 8), np.int32))


# --------------------------------------------------------------------------
# over tp2: two gloo ranks against the reference in shard_map
# --------------------------------------------------------------------------
TP_LEGS = {2: [{"name": "spec_tp2", "kind": "spec", "mesh": {"tp": 2},
                "tree": "tiny", "draft": "tinyd", "max_new": MAX_NEW,
                "spec_len": 3}]}


def test_speculative_tp2_matches_reference(tmp_path_factory):
    """``make_speculative_generate_fn(tp_axis=)`` on two ranks, each on
    its shards of the target and the draft: every rank's tokens and
    rounds equal the reference's sharded sampler's."""
    trees = {"tiny": j_init(jax.random.PRNGKey(0), JCFG),
             "tinyd": j_init(jax.random.PRNGKey(9), JCFG)}
    prompt = np.random.default_rng(4).integers(0, 256, (2, 7)).astype(
        np.int32)
    arrays = {"spec_tp2_prompt": prompt}
    for t, tree in trees.items():
        arrays.update({f"{t}_p{i}": np.asarray(a)
                       for i, a in enumerate(tree_leaves(tree))})
    ranks = port_groups("torch_speculative", TP_LEGS, arrays,
                        tmp_path_factory, script="sharded_rank.py")[2]
    specs = j_gpt_specs(JCFG, "tp")
    gen = j_spec(JCFG, JCFG, max_new=MAX_NEW, spec_len=3, tp_axis="tp")
    toks, rounds = jax.jit(jax.shard_map(
        gen, mesh=j_mesh({"tp": 2}), in_specs=(specs, specs, P()),
        out_specs=(P(), P()), check_vma=False))(
            trees["tiny"], trees["tinyd"], jnp.asarray(prompt))
    for out in ranks:
        np.testing.assert_array_equal(out["spec_tp2_tokens"],
                                      np.asarray(toks))
        assert int(out["spec_tp2_rounds"]) == int(rounds)


# --------------------------------------------------------------------------
# the scheduler's speculative lane
# --------------------------------------------------------------------------
def _jcounters():
    return jmetrics.get_registry().snapshot()["counters"]


def _lane(jp, tp, reqs, jpol, tpol, **kw):
    """Serve ``reqs`` (``(rid, prompt, max_new)``) with the policies on
    both schedulers: (reference results, counter deltas), (port
    results, counters, scheduler)."""
    before = _jcounters()
    jres = JScheduler(jp, JCFG, **kw).serve(
        [JRequest(rid=r, prompt=p, max_new=n, spec=jpol)
         for r, p, n in reqs])
    after = _jcounters()
    jc = {k: after.get(k, 0) - before.get(k, 0) for k in SPEC_COUNTERS}
    sched = Scheduler(tp, CFG, device="cpu", **kw)
    tres = sched.serve([Request(rid=r, prompt=p, max_new=n, spec=tpol)
                        for r, p, n in reqs])
    tc = get_registry().snapshot()["counters"]
    return (jres, jc), (tres, {k: tc.get(k, 0) for k in SPEC_COUNTERS},
                        sched)


def _check_lane(ref, port, reqs, tp):
    (jres, jc), (tres, tc, sched) = ref, port
    for rid, prompt, n in reqs:
        np.testing.assert_array_equal(jres[rid]["tokens"],
                                      _plain(CFG, tp, prompt[None], n)[0])
        np.testing.assert_array_equal(tres[rid]["tokens"],
                                      jres[rid]["tokens"], err_msg=rid)
        assert tres[rid]["spec_rounds"] == jres[rid]["spec_rounds"], rid
    assert tc == jc, (tc, jc)
    assert tc["serve.decode_tokens"] == 0
    assert sched.cache.leaked_blocks() == 0


def test_speculative_lookup_lane_matches_reference(model):
    """``test_serve.py``'s lookup lane: three requests on repetitive
    prompts, fewer rounds than tokens, no packed decode step."""
    jp, tp, _ = model
    rng = np.random.default_rng(19)
    reqs = []
    for i in range(3):
        base = rng.integers(0, CFG.vocab_size, 4).astype(np.int32)
        reqs.append((f"s{i}", np.tile(base, 3)[:10], 10))
    ref, port = _lane(jp, tp, reqs, JSpecPolicy("lookup", spec_len=4),
                      SpecPolicy("lookup", spec_len=4), max_batch=3,
                      prefill_chunk=16)
    _check_lane(ref, port, reqs, tp)
    rounds = sum(port[0][r]["spec_rounds"] for r, _, _ in reqs)
    assert 0 < rounds < sum(n for _, _, n in reqs)
    assert port[1]["serve.spec_tokens"] > rounds


def _draft_models():
    djcfg = JConfig(vocab_size=JCFG.vocab_size, max_seq=JCFG.max_seq,
                    d_model=32, n_heads=2, n_layers=1, d_ff=64)
    dtcfg = GPTConfig(vocab_size=CFG.vocab_size, max_seq=CFG.max_seq,
                      d_model=32, n_heads=2, n_layers=1, d_ff=64)
    jd, td = _weights(djcfg, dtcfg, 5)
    return (JSpecPolicy("draft", spec_len=3, draft_params=jd,
                        draft_cfg=djcfg),
            SpecPolicy("draft", spec_len=3, draft_params=td,
                       draft_cfg=dtcfg))


def test_speculative_draft_lane_one_request(model):
    """The draft-model lane on one request: its per-request dense draft
    cache, rewound with the verify."""
    jp, tp, _ = model
    rng = np.random.default_rng(23)
    reqs = [("d0", rng.integers(0, CFG.vocab_size, 9).astype(np.int32), 8)]
    ref, port = _lane(jp, tp, reqs, *_draft_models(), max_batch=2)
    _check_lane(ref, port, reqs, tp)


@pytest.mark.slow
def test_speculative_draft_lane_matches_reference(model):
    """``test_serve.py``'s draft-model lane: three mixed requests."""
    jp, tp, _ = model
    rng = np.random.default_rng(23)
    reqs = [(f"r{i}", rng.integers(0, CFG.vocab_size, T0).astype(np.int32),
             mn) for i, (T0, mn) in enumerate(((4, 8), (9, 5), (14, 10)))]
    ref, port = _lane(jp, tp, reqs, *_draft_models(), max_batch=3)
    _check_lane(ref, port, reqs, tp)


def test_spec_lane_beside_plain_requests(model):
    """A lookup request and a plain one on one replica: the plain one
    rides the packed step, the spec one never does; both equal solo."""
    jp, tp, _ = model
    rng = np.random.default_rng(29)
    base = rng.integers(0, CFG.vocab_size, 4).astype(np.int32)
    plain = rng.integers(0, CFG.vocab_size, 7).astype(np.int32)
    sched = Scheduler(tp, CFG, max_batch=2, device="cpu")
    res = sched.serve([
        Request(rid="spec", prompt=np.tile(base, 3), max_new=9,
                spec=SpecPolicy("lookup", spec_len=3)),
        Request(rid="plain", prompt=plain, max_new=9)])
    for rid, prompt in (("spec", np.tile(base, 3)), ("plain", plain)):
        np.testing.assert_array_equal(
            res[rid]["tokens"], _plain(CFG, tp, prompt[None], 9)[0])
    c = get_registry().snapshot()["counters"]
    assert c["serve.decode_tokens"] == 8        # the plain request alone
    assert res["plain"]["spec_rounds"] == 0 < res["spec"]["spec_rounds"]
    assert sched.cache.leaked_blocks() == 0


def test_spec_submit_refusals(model):
    """Speculation is greedy-only, and spec_len counts against max_seq
    and the pool, as in the reference."""
    _, tp, _ = model
    sched = Scheduler(tp, CFG, device="cpu")
    p = np.arange(8, dtype=np.int32)
    with pytest.raises(ValueError, match="greedy-only"):
        sched.submit(Request(rid="t", prompt=p, max_new=4, temperature=0.5,
                             spec=SpecPolicy("lookup", spec_len=4)))
    with pytest.raises(ValueError, match="spec_len"):
        sched.submit(Request(rid="m", prompt=p, max_new=CFG.max_seq - 10,
                             spec=SpecPolicy("lookup", spec_len=4)))
    with pytest.raises(ValueError, match="draft_params"):
        SpecPolicy("draft", spec_len=2)
    with pytest.raises(ValueError, match="unknown spec kind"):
        SpecPolicy("beam")
