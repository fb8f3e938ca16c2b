"""The port's BERT (``byteps_tpu_torch/models/bert.py``) and its train
step against the reference's, on ``BertConfig.tiny()`` in f32 from the
reference's ``PRNGKey(0)`` weights (carried over by
``models.convert.tree_from_numpy``):

* the tree converts leaf for leaf, in ``jax.tree.flatten`` order, and
  back; a tree of another structure raises;
* the forward's MLM logits, and ``bert_mlm_loss`` fused (the chunked
  readout + CE with ``mlm_bias``) and dense, with every leaf's
  gradient, within 1e-5; the chunked CE with a bias against the
  reference's, values and the gradients of h, the head and the bias;
* ``make_bert_train_step`` at dp = 1 in this process, raw and onebit +
  EF, two steps: raw losses within 1e-5 and parameters too but for
  elements whose gradient is roundoff, which AdamW amplifies
  (``family_parity.assert_params_close``: at most a share of 1e-4, each
  within lr a step), onebit losses
  within 1e-4 and the parameters further than 1e-5 from the reference's
  below a share of 1e-3 (the GPT onebit tests' bounds);
* the same over two gloo ranks (``tests/helpers/family_parity.py``):
  dp2 raw and onebit + EF, dp2 with ``accum_steps=2`` on rows whose mask
  counts differ (each microbatch weighted by its count, as the
  reference's ``weight_fn``), tp2 with the vocab-parallel readout (the
  bias split over tp), sp2 (the non-causal ring) and dp2 with ZeRO-1 and
  remat;
* ``accum_steps=2`` equals the full-batch step in the port too, and
  ``synthetic_mlm_batch`` masks as it says."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from family_parity import (CFGS, ONEBIT_EF, ONEBIT_LOSS_TOL,  # noqa: E402
                           ONEBIT_OFF_SHARE, STEPS, TOL, assert_params_close,
                           batches, family_tree, flat, j_mesh, off_share,
                           port_legs, ref_run)

from byteps_tpu.models import bert as jbert  # noqa: E402
from byteps_tpu.models.train import make_bert_train_step as j_step  # noqa: E402,E501
from byteps_tpu.ops.chunked_ce import chunked_ce_nll as j_chunked_ce  # noqa: E402,E501
from byteps_tpu.ops.chunked_ce import dense_ce_nll as j_dense_ce  # noqa: E402
from byteps_tpu_torch.models import (BertConfig, bert_forward,  # noqa: E402
                                     bert_mlm_loss, flat_leaves,
                                     make_bert_train_step,
                                     synthetic_mlm_batch, tree_from_numpy,
                                     tree_to_numpy)
from byteps_tpu_torch.ops.chunked_ce import chunked_ce_nll  # noqa: E402

torch.set_num_threads(1)
CFG, JCFG = BertConfig.tiny(), CFGS["bert"]
DP2_LEGS = {"bert_dp2": ({"dp": 2}, {}),
            "bert_dp2_onebit": ({"dp": 2},
                                {"compression_params": ONEBIT_EF}),
            "bert_dp2_accum": ({"dp": 2}, {"accum_steps": 2}),
            "bert_tp2_vocab": ({"tp": 2}, {"chunked_ce": "vocab_parallel"}),
            "bert_sp2": ({"sp": 2}, {}),
            "bert_dp2_zero1_remat": ({"dp": 2}, {"zero_1": True,
                                                 "remat": True})}


@pytest.fixture(scope="module")
def tree():
    return family_tree("bert")


@pytest.fixture(scope="module")
def batch():
    return batches()["bert"]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return port_legs(tmp_path_factory)


def _params(tree):
    return tree_from_numpy(tree, CFG, device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_tree_converts_leaf_for_leaf(tree):
    p = _params(tree)
    got = [t.detach().numpy() for t in flat_leaves(p)]
    want = [np.asarray(x) for x in jax.tree.leaves(tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    back = tree_to_numpy(p)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    np.testing.assert_array_equal(flat(back), flat(tree))
    bad = dict(tree)
    del bad["wtype"]
    with pytest.raises(ValueError, match="expects keys"):
        tree_from_numpy(bad, CFG, device="cpu")
    with pytest.raises(ValueError, match="list of 2"):
        tree_from_numpy({**tree, "blocks": tree["blocks"][:1]}, CFG,
                        device="cpu")


def test_forward_logits_match_reference(tree, batch):
    tok = batch[0]
    want = np.asarray(jbert.bert_forward(jax.tree.map(jnp.asarray, tree),
                                         jnp.asarray(tok), JCFG))
    got = bert_forward(_params(tree), _t(tok), CFG).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "dense"])
def test_mlm_loss_and_grads_match_reference(tree, batch, chunked):
    tok, tgt, mask = batch
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jbert.bert_mlm_loss(p, jnp.asarray(tok), jnp.asarray(tgt),
                                      jnp.asarray(mask), JCFG,
                                      chunked_ce=chunked)))(
        jax.tree.map(jnp.asarray, tree))
    p = _params(tree)
    p.requires_grad_(True)
    loss = bert_mlm_loss(p, _t(tok), _t(tgt), _t(mask), CFG,
                         chunked_ce=chunked)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= TOL
    # wtype takes no gradient without type ids: the reference's zeros
    got = [np.zeros(t.shape, np.float32) if t.grad is None
           else t.grad.numpy() for t in flat_leaves(p)]
    for g, w in zip(got, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("row_block", [None, 8], ids=["whole", "blocks8"])
def test_chunked_ce_bias_matches_reference(row_block):
    rng = np.random.default_rng(5)
    h = rng.standard_normal((3, 11, 24)).astype(np.float32)
    head = rng.standard_normal((24, 40)).astype(np.float32)
    bias = rng.standard_normal(40).astype(np.float32)
    tgt = rng.integers(0, 40, (3, 11))

    def jloss(h_, hd_, b_):
        return j_chunked_ce(h_, hd_, jnp.asarray(tgt), bias=b_,
                            row_block=row_block).mean()

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(head), jnp.asarray(bias))
    dense = np.asarray(j_dense_ce(jnp.asarray(h), jnp.asarray(head),
                                  jnp.asarray(tgt), bias=jnp.asarray(bias)))
    th, thd, tb = (_t(a).requires_grad_() for a in (h, head, bias))
    nll = chunked_ce_nll(th, thd, _t(tgt), row_block=row_block, bias=tb)
    nll.mean().backward()
    np.testing.assert_allclose(nll.detach().numpy(), dense, rtol=TOL,
                               atol=TOL)
    assert abs(float(nll.mean()) - float(jl)) <= TOL
    for g, w in zip((th.grad, thd.grad, tb.grad), jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="bias must be"):
        chunked_ce_nll(th, thd, _t(tgt), bias=tb[:-1])


def _ref_one(tree, batch, steps=STEPS, **kw):
    step, params, opt, bsh = j_step(JCFG, j_mesh({"dp": 1}),
                                    optax.adamw(1e-3), **kw)
    args = [jax.device_put(jnp.asarray(b), bsh) for b in batch]
    losses = []
    for _ in range(steps):
        loss, params, opt = step(params, opt, *args)
        losses.append(float(loss))
    return np.array(losses), flat(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("leg", ["raw", "onebit_ef"])
def test_step_one_rank_matches_reference(tree, batch, leg):
    kw = {"compression_params": ONEBIT_EF} if leg == "onebit_ef" else {}
    want_l, want_p = _ref_one(tree, batch, **kw)
    step, p, _ = make_bert_train_step(CFG, init_params=_params(tree),
                                      device="cpu", **kw)
    got_l = np.array([float(step(*batch)) for _ in range(STEPS)])
    got_p = np.concatenate([t.detach().numpy().ravel()
                            for t in flat_leaves(p)])
    if leg == "raw":
        np.testing.assert_allclose(got_l, want_l, rtol=TOL, atol=TOL)
        assert_params_close(got_p, want_p)
    else:
        assert np.abs(got_l - want_l).max() <= ONEBIT_LOSS_TOL
        assert off_share(got_p, want_p) <= ONEBIT_OFF_SHARE


@pytest.mark.parametrize("leg", sorted(DP2_LEGS))
def test_step_two_ranks_matches_reference(port, leg):
    axes, kw = DP2_LEGS[leg]
    want = ref_run("bert", axes, **kw)
    for rank in port:
        got_l, got_p = rank[f"{leg}_loss"], rank[f"{leg}_params"]
        if "onebit" in leg:
            assert np.abs(got_l - want["loss"]).max() <= ONEBIT_LOSS_TOL
            assert off_share(got_p, want["params"]) <= ONEBIT_OFF_SHARE
        else:
            np.testing.assert_allclose(got_l, want["loss"], rtol=TOL,
                                       atol=TOL)
            assert_params_close(got_p, want["params"])
    np.testing.assert_array_equal(port[0][f"{leg}_params"],
                                  port[1][f"{leg}_params"])


def test_accumulation_weights_microbatches_by_mask_count(tree, batch):
    counts = batch[2].sum(axis=1)
    assert len(set(counts[:2].tolist())) == 2     # the microbatches differ
    full, p_full, _ = make_bert_train_step(CFG, init_params=_params(tree),
                                           device="cpu")
    acc, p_acc, _ = make_bert_train_step(CFG, init_params=_params(tree),
                                         device="cpu", accum_steps=2)
    rows = [b[:2] for b in batch]
    for _ in range(STEPS):
        assert abs(float(full(*rows)) - float(acc(*rows))) <= TOL
    assert_params_close(*(np.concatenate([t.detach().numpy().ravel()
                                          for t in flat_leaves(p)])
                          for p in (p_acc, p_full)))
    with pytest.raises(ValueError, match="not divisible by accum_steps=3"):
        make_bert_train_step(CFG, init_params=_params(tree), device="cpu",
                             accum_steps=3)[0](*rows)


def test_synthetic_mlm_batch():
    g = torch.Generator().manual_seed(0)
    tok, tgt, mask = synthetic_mlm_batch(g, CFG, 8, 64)
    assert tok.shape == tgt.shape == mask.shape == (8, 64)
    assert mask.dtype == torch.int32
    m = mask.bool()
    assert bool((tok[m] == CFG.vocab_size - 1).all())
    assert bool((tok[~m] == tgt[~m]).all())
    assert 0.05 < float(mask.float().mean()) < 0.3


@pytest.mark.parametrize("tp", [None, "tp"])
def test_param_specs_match_reference(tp):
    from jax.sharding import PartitionSpec

    from byteps_tpu_torch.models.bert import bert_param_specs

    want = jax.tree.map(tuple, jbert.bert_param_specs(JCFG, tp),
                        is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert bert_param_specs(CFG, tp) == want
