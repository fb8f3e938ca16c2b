"""The port's T5 (``byteps_tpu_torch/models/t5.py``): training and cached
seq2seq generation against the reference's, on ``T5Config.tiny()`` in
f32 from the reference's ``PRNGKey(0)`` weights:

* the teacher-forced logits, and ``t5_loss`` fused and dense with every
  leaf's gradient, within 1e-5; the cross-attention on a rectangular
  block (8 target rows over 16 encoder rows) likewise;
* ``make_t5_train_step`` at dp = 1 in this process and over two gloo
  ranks at dp2, tp2 and sp2 (``tests/helpers/family_parity.py``; the
  target is half the source's length, so sp2's cross-attention ring
  rotates 8-row memory blocks under 4-row query blocks), two steps of
  AdamW: losses within 1e-5, parameters too but for AdamW's roundoff
  elements (``family_parity.assert_params_close``);
* ``t5_decode_cached``: a 3-token prefill then one-token steps give the
  reference's logits and the port's teacher-forced ``t5_decode``'s,
  within 1e-5;
* greedy ``make_t5_generate_fn`` emits the reference's tokens exactly.
  At ``PRNGKey(0)``'s scale the tied readout returns the input token,
  so every stream is BOS; the test scales every matrix by 20, where the
  streams vary, and asserts that they do. Sampling (top-k, top-p) is
  seeded by the generator; the ``max_tgt`` guard raises the reference's
  error."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from family_parity import (CFGS, STEPS, TOL, assert_params_close,  # noqa: E402,E501
                           batches, family_tree, flat, j_mesh, port_legs,
                           ref_run)

from byteps_tpu.models import t5 as jt5  # noqa: E402
from byteps_tpu.models.train import make_t5_train_step as j_step  # noqa: E402,E501
from byteps_tpu_torch.models import (T5Config, flat_leaves,  # noqa: E402
                                     make_t5_generate_fn, make_t5_train_step,
                                     synthetic_seq2seq_batch, t5_decode,
                                     t5_decode_cached, t5_encode, t5_forward,
                                     t5_loss, tree_from_numpy)
from byteps_tpu_torch.models.t5 import (cross_attention, t5_cross_kv,  # noqa: E402,E501
                                        t5_init_cache)

torch.set_num_threads(1)
CFG, JCFG = T5Config.tiny(), CFGS["t5"]
GEN_SCALE = 20.0            # the matrices' scale at which greedy varies


@pytest.fixture(scope="module")
def tree():
    return family_tree("t5")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return port_legs(tmp_path_factory)


def _params(tree):
    return tree_from_numpy(tree, CFG, device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "dense"])
def test_logits_loss_and_grads_match_reference(tree, chunked):
    src, ti, to = batches()["t5"]
    jp = jax.tree.map(jnp.asarray, tree)
    want = np.asarray(jax.jit(jt5.t5_forward, static_argnums=3)(
        jp, jnp.asarray(src), jnp.asarray(ti), JCFG))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jt5.t5_loss(
        p, jnp.asarray(src), jnp.asarray(ti), jnp.asarray(to), JCFG,
        chunked_ce=chunked)))(jp)
    p = _params(tree)
    got = t5_forward(p, _t(src), _t(ti), CFG).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    p.requires_grad_(True)
    loss = t5_loss(p, _t(src), _t(ti), _t(to), CFG, chunked_ce=chunked)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= TOL
    for t, w in zip(flat_leaves(p), jax.tree.leaves(jg)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_rectangular_cross_attention_matches_reference(tree):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, CFG.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 16, CFG.d_model)).astype(np.float32)
    blk = tree["dec_blocks"][0]
    jx, jm = jnp.asarray(x), jnp.asarray(mem)
    jb = jax.tree.map(jnp.asarray, blk)
    want, (jdx, jdm) = jax.value_and_grad(
        lambda a, b: jt5.cross_attention(a, b, jb, CFG.head_dim,
                                         None).sum(), argnums=(0, 1))(jx, jm)
    p = _params(tree)
    tx, tm = _t(x).requires_grad_(), _t(mem).requires_grad_()
    out = cross_attention(tx, tm, p["dec_blocks"][0], CFG.head_dim)
    out.sum().backward()
    np.testing.assert_allclose(float(out.sum().detach()), float(want),
                               rtol=TOL, atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jdm), rtol=TOL,
                               atol=TOL)


def test_step_one_rank_matches_reference(tree):
    batch = batches()["t5"]
    step, params, opt, bsh = j_step(JCFG, j_mesh({"dp": 1}),
                                    optax.adamw(1e-3))
    args = [jax.device_put(jnp.asarray(b), bsh) for b in batch]
    want_l = []
    for _ in range(STEPS):
        loss, params, opt = step(params, opt, *args)
        want_l.append(float(loss))
    s, p, _ = make_t5_train_step(CFG, init_params=_params(tree),
                                 device="cpu")
    got_l = [float(s(*batch)) for _ in range(STEPS)]
    np.testing.assert_allclose(got_l, want_l, rtol=TOL, atol=TOL)
    assert_params_close(np.concatenate([t.detach().numpy().ravel()
                                        for t in flat_leaves(p)]),
                        flat(jax.tree.map(np.asarray, params)))


@pytest.mark.parametrize("leg,axes", [("t5_dp2", {"dp": 2}),
                                      ("t5_tp2", {"tp": 2}),
                                      ("t5_sp2", {"sp": 2})])
def test_step_two_ranks_matches_reference(port, leg, axes):
    want = ref_run("t5", axes)
    for rank in port:
        np.testing.assert_allclose(rank[f"{leg}_loss"], want["loss"],
                                   rtol=TOL, atol=TOL)
        assert_params_close(rank[f"{leg}_params"], want["params"])
    np.testing.assert_array_equal(port[0][f"{leg}_params"],
                                  port[1][f"{leg}_params"])


def test_cached_decode_matches_reference_and_teacher_forcing(tree):
    src, ti, _ = batches()["t5"]
    jp = jax.tree.map(jnp.asarray, tree)
    jmem = jax.jit(jt5.t5_encode, static_argnums=2)(jp, jnp.asarray(src),
                                                    JCFG)
    jk, jv = jt5.t5_cross_kv(jp, jmem, JCFG)
    j_cached = jax.jit(jt5.t5_decode_cached, static_argnums=5)
    jcache = jt5.t5_init_cache(JCFG, src.shape[0])
    p = _params(tree)
    mem = t5_encode(p, _t(src), CFG)
    ck, cv = t5_cross_kv(p, mem, CFG)
    cache = t5_init_cache(CFG, src.shape[0], device="cpu")
    got, want = [], []
    for a, b in ((0, 3), (3, 4), (4, 5), (5, 6)):
        jl, jcache = j_cached(jp, jnp.asarray(ti[:, a:b]), jcache, jk, jv,
                              JCFG)
        tl, cache = t5_decode_cached(p, _t(ti[:, a:b]), cache, ck, cv, CFG)
        want.append(np.asarray(jl))
        got.append(tl.numpy())
    assert cache.length == 6
    got, want = np.concatenate(got, 1), np.concatenate(want, 1)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    with torch.no_grad():
        tf = t5_decode(p, mem, _t(ti[:, :6]), CFG).numpy()
    np.testing.assert_allclose(got, tf, rtol=TOL, atol=TOL)


def test_greedy_generation_equals_reference(tree):
    scaled = jax.tree.map(lambda a: a * GEN_SCALE if a.ndim == 2 else a,
                          tree)
    src = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 16))
    want = np.asarray(jt5.make_t5_generate_fn(JCFG, 12)(
        jax.tree.map(jnp.asarray, scaled), jnp.asarray(src, jnp.int32),
        jax.random.PRNGKey(0), 0.0))
    got = make_t5_generate_fn(CFG, 12, device="cpu")(
        tree_from_numpy(scaled, CFG, device="cpu"), src)
    assert got.dtype == torch.int32 and got.shape == (2, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 2            # the stream is not constant


def test_sampling_and_guards(tree):
    p = _params(tree)
    src = np.random.default_rng(2).integers(0, CFG.vocab_size, (2, 8))
    gen = make_t5_generate_fn(CFG, 6, top_k=5, top_p=0.9, device="cpu")
    a = gen(p, src, torch.Generator().manual_seed(3), 1.0)
    b = gen(p, src, torch.Generator().manual_seed(3), 1.0)
    assert torch.equal(a, b) and a.shape == (2, 6)
    assert int(a.min()) >= 0 and int(a.max()) < CFG.vocab_size
    with pytest.raises(ValueError, match=r"BOS \+ max_new \(65\) exceeds "
                       r"cfg.max_tgt \(64\)"):
        make_t5_generate_fn(CFG, 64, device="cpu")
    with pytest.raises(ValueError, match=r"BOS \+ max_new \(65\) exceeds"):
        jt5.make_t5_generate_fn(JCFG, 64)
    make_t5_generate_fn(CFG, 63, device="cpu")


def test_synthetic_seq2seq_batch():
    src, ti, to = synthetic_seq2seq_batch(torch.Generator().manual_seed(0),
                                          CFG, 3, 10, 7)
    assert src.shape == (3, 10) and ti.shape == to.shape == (3, 7)
    assert bool((ti[:, 0] == 0).all())
    assert torch.equal(ti[:, 1:], to[:, :-1])


@pytest.mark.parametrize("tp", [None, "tp"])
def test_param_specs_match_reference(tp):
    from jax.sharding import PartitionSpec

    from byteps_tpu_torch.models.t5 import t5_param_specs

    want = jax.tree.map(tuple, jt5.t5_param_specs(JCFG, tp),
                        is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert t5_param_specs(CFG, tp) == want
