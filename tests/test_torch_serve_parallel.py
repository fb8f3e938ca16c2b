"""The serve tier over tp: the paged decode and prefill steps and the
``Scheduler`` on a tp2 mesh, against the reference's steps and the port's
one-rank tier, on the CPU in f32, from the reference's own weights.

The port's tp legs run as gloo rank processes
(``tests/helpers/sharded_rank.py``, each group once a test session under
a file lock):

* the paged steps: a fixed schedule (``sharded_rank.paged_schedule``: two
  prompts prefilled into their own block tables, the second in two
  chunks, then three packed decode steps of both rows at their own
  positions) through ``make_paged_prefill_fn``/``make_paged_decode_fn``
  with ``tp_axis``: every call's logits on each rank within 1e-5 of the
  largest magnitude of the reference's same factories with
  ``tp_axis="tp"`` in ``shard_map`` (the pool split on its head axis),
  the two ranks' logits bit-equal, and within 1e-5 of the port's
  one-rank schedule.
* ``Scheduler(tp_axis=)`` serving eight greedy requests on a pool that
  forces chunked prefill and preemption: each request's tokens on each
  rank equal to the port's one-rank ``Scheduler`` on the whole weights
  and to the reference's solo ``make_generate_fn`` exactly; the clock
  admission decides on (``Scheduler._now``) reads the same on both
  ranks.
* the refusals: an ``AdapterPool`` under a live tp axis (ROADMAP A.7),
  and the paged decode step's MoE refusal, which mirrors the reference's
  own (``byteps_tpu/serve/paged_cache.py:844``).
"""

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
from sharded_rank import (PAGED_BS, SCHED_KW, paged_schedule,  # noqa: E402
                          sched_requests)

from byteps_tpu.models import GPTConfig as JConfig  # noqa: E402
from byteps_tpu.models import gpt_param_specs as j_gpt_specs  # noqa: E402
from byteps_tpu.models.generate import make_generate_fn as j_generate  # noqa: E402,E501
from byteps_tpu.models.gpt import gpt_init as j_init  # noqa: E402
from byteps_tpu.serve import paged_cache as jpc  # noqa: E402
from byteps_tpu_torch.common.metrics import reset_registry  # noqa: E402
from byteps_tpu_torch.models import (GPTConfig, MoEGPTConfig,  # noqa: E402
                                     moe_gpt_init, params_from_numpy)
from byteps_tpu_torch.parallel.mesh import Axis  # noqa: E402
from byteps_tpu_torch.serve import AdapterPool, PagedKVCache, Scheduler  # noqa: E402,E501
from byteps_tpu_torch.serve.paged_cache import make_paged_decode_fn  # noqa: E402,E501

torch.set_num_threads(1)
LOGIT_TOL = 1e-5                 # of the largest logit magnitude
POOL_BLOCKS, STEPS = 9, 3
N_REQ, MAX_NEW = 8, 6
LEGS = {2: [{"name": "paged_tp2", "kind": "paged", "mesh": {"tp": 2},
             "tree": "tiny", "pool_blocks": POOL_BLOCKS, "steps": STEPS},
            {"name": "sched_tp2", "kind": "sched", "mesh": {"tp": 2},
             "tree": "tiny", "n": N_REQ, "max_new": MAX_NEW}]}


@pytest.fixture(autouse=True)
def _fresh_registry():
    reset_registry()
    yield
    reset_registry()


@pytest.fixture(scope="module")
def data():
    tree = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0),
                                           JConfig.tiny()))
    rng = np.random.default_rng(13)
    arrays = {f"tiny_p{i}": a for i, a in enumerate(tree_leaves(tree))}
    arrays["paged_p0"] = rng.integers(0, 256, 5).astype(np.int32)
    arrays["paged_p1"] = rng.integers(0, 256, 12).astype(np.int32)
    arrays["paged_toks"] = rng.integers(0, 256, (STEPS, 2)).astype(np.int32)
    for i in range(N_REQ):
        arrays[f"sched_prompt_{i}"] = rng.integers(
            0, 256, [4, 13, 9, 21, 6, 17, 11, 5][i]).astype(np.int32)
    return tree, arrays


@pytest.fixture(scope="module")
def port(data, tmp_path_factory):
    return port_groups("torch_serve_parallel", LEGS, data[1],
                       tmp_path_factory, script="sharded_rank.py")


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())


def _ref_paged(tree, d):
    """The reference's factories with ``tp_axis="tp"`` in ``shard_map``
    on the schedule of ``sharded_rank.paged_schedule``: every call's
    logits, flat."""
    cfg = JConfig.tiny()
    L, h, D = cfg.n_layers, cfg.n_heads, cfg.head_dim
    pool = jpc.PoolState(
        k=jnp.zeros((L, POOL_BLOCKS, PAGED_BS, h, D), cfg.dtype),
        v=jnp.zeros((L, POOL_BLOCKS, PAGED_BS, h, D), cfg.dtype))
    heads = P(None, None, None, "tp", None)
    pspec = jpc.PoolState(k=heads, v=heads, k_scale=None, v_scale=None)
    p0, p1 = jnp.asarray(d["paged_p0"])[None], jnp.asarray(d["paged_p1"])[None]
    cut = p1.shape[1] // 2
    tables = jnp.array([[1, 2], [3, 4]], jnp.int32)

    def run(params, pool):
        pre = lambda c, r: jpc.make_paged_prefill_fn(  # noqa: E731
            cfg, PAGED_BS, c, "tp", r)
        out = []
        lg, pool = pre(p0.shape[1], True)(params, pool, p0, 0, tables[0])
        out.append(lg.ravel())
        _, pool = pre(cut, False)(params, pool, p1[:, :cut], 0, tables[1])
        lg, pool = pre(p1.shape[1] - cut, True)(params, pool, p1[:, cut:],
                                                cut, tables[1])
        out.append(lg.ravel())
        pos = jnp.array([p0.shape[1], p1.shape[1]], jnp.int32)
        dec = jpc.make_paged_decode_fn(cfg, PAGED_BS, "tp")
        for s in range(STEPS):
            lg, pool = dec(params, pool, jnp.asarray(d["paged_toks"][s]),
                           pos, tables)
            out.append(lg.ravel())
            pos = pos + 1
        return jnp.concatenate(out)

    return np.asarray(jax.jit(jax.shard_map(
        run, mesh=j_mesh({"tp": 2}), in_specs=(j_gpt_specs(cfg, "tp"),
                                               pspec),
        out_specs=P(), check_vma=False))(jax.tree.map(jnp.asarray, tree),
                                         pool))


def test_paged_steps_on_tp2_match_reference_and_one_rank(port, data):
    tree, arrays = data
    want = _ref_paged(tree, arrays)
    params = params_from_numpy(tree, GPTConfig.tiny(), device="cpu")
    one = np.concatenate([o.numpy().ravel() for o in paged_schedule(
        GPTConfig.tiny(), params, None, POOL_BLOCKS, STEPS, arrays)])
    _close(one, want)
    outs = port[2]
    for o in outs:
        _close(o["paged_tp2_logits"], want)
        _close(o["paged_tp2_logits"], one)
    np.testing.assert_array_equal(outs[0]["paged_tp2_logits"],
                                  outs[1]["paged_tp2_logits"])


def test_scheduler_on_tp2_equals_one_rank_and_reference(port, data):
    tree, arrays = data
    params = params_from_numpy(tree, GPTConfig.tiny(), device="cpu")
    reqs = sched_requests(arrays, N_REQ, MAX_NEW)
    sched = Scheduler(params, GPTConfig.tiny(), **SCHED_KW)
    res = sched.serve(reqs)
    assert sched._m["preempted"].value() > 0      # the pool forced one
    one = np.concatenate([res[r.rid]["tokens"] for r in reqs])
    jgen = j_generate(JConfig.tiny(), MAX_NEW)
    jp = jax.tree.map(jnp.asarray, tree)
    solo = np.concatenate([np.asarray(jgen(
        jp, jnp.asarray(r.prompt)[None], jax.random.PRNGKey(0), 0.0))[0]
        for r in reqs])
    np.testing.assert_array_equal(one, solo)
    outs = port[2]
    for o in outs:
        np.testing.assert_array_equal(o["sched_tp2_tokens"], one)
    assert float(outs[0]["sched_tp2_clock"]) == float(
        outs[1]["sched_tp2_clock"])


def test_serve_tp_refusals():
    cfg = GPTConfig.tiny()
    params = params_from_numpy(
        jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0),
                                        JConfig.tiny())), cfg, device="cpu")
    tp = Axis("tp", 2, 0, (0, 1), group=object())
    pool = AdapterPool(cfg, n_slots=2, rank_bucket=4, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A.7"):
        Scheduler(params, cfg, tp_axis=tp, adapter_pool=pool, **SCHED_KW)
    mcfg = MoEGPTConfig.tiny()
    moe = moe_gpt_init(mcfg, torch.Generator().manual_seed(0), device="cpu")
    cache = PagedKVCache(mcfg, block_size=PAGED_BS, pool_blocks=3,
                         max_batch=1, device="cpu")
    step = make_paged_decode_fn(mcfg, PAGED_BS)
    with pytest.raises(NotImplementedError,
                       match="byteps_tpu/serve/paged_cache.py:844"):
        step(moe, cache.state, torch.tensor([1]), torch.tensor([0]),
             torch.tensor([[1]]))
