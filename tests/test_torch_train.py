"""The port's data-parallel training step against the reference, from the
reference's own weights (``params_from_numpy``) and one numpy batch, on
``GPTConfig.tiny()`` in f32:

* ``gpt_loss`` and its gradient against ``jax.value_and_grad`` of the
  reference's ``gpt_loss``, fused (chunked) and dense readout + CE,
  remat on and off — 1e-5: the same f32 math in a different summation
  order, on sums of at most a few hundred terms;
* three steps of the reference's ``make_gpt_train_step`` (dp = 1 mesh,
  ``optax.adamw(1e-3)``) against the port's ``make_gpt_train_step``,
  raw, onebit with error feedback (with and without Nesterov
  momentum) and top-k block with error feedback, with a small partition
  so the gradient spans several chunks whose boundaries cut through
  leaves.
  raw: losses and parameters within 1e-5. onebit: losses within 1e-4
  and the EF residual after step 1 within 1e-5 outside the key biases.
  The exact gradient of ``bk`` is 0 (a bias on every key shifts a
  softmax row by a constant), so the computed one is roundoff and its
  signs are noise that differs between the frameworks; each flipped
  sign moves that residual element by 2·scale. onebit parameters are
  not all-close for the same reason, and because the two frameworks
  reduce mean(|x|) in different orders (scales agree to ~1e-6
  relative): a sign that flips moves its parameter by about 2·lr
  through Adam. So the test bounds the share of parameters off by
  more than 1e-5 (below 1e-3) instead.

The card runs the same step on the kernels; ``chip_smoke.py`` holds it
against the plain versions (phase ``train_tiny``)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byteps_tpu.models import GPTConfig as JConfig
from byteps_tpu.models.gpt import gpt_init as j_init
from byteps_tpu.models.gpt import gpt_loss as j_loss
from byteps_tpu.models.train import make_gpt_train_step as j_train_step
from byteps_tpu.ops.chunked_ce import chunked_ce_nll as j_chunked_ce
from byteps_tpu.parallel import MeshAxes, make_mesh
from byteps_tpu_torch.models import (GPTConfig, flat_leaves, gpt_loss,
                                     make_gpt_train_step, params_from_numpy,
                                     params_to_numpy, synthetic_batch)
from byteps_tpu_torch.ops.chunked_ce import chunked_ce_nll

torch.set_num_threads(1)

TOL = 1e-5
ONEBIT_LOSS_TOL = 1e-4
ONEBIT_OFF_SHARE = 1e-3
# 4096-byte partitions: 1024 f32 elements, so the tiny model's 87,552
# gradient elements cross 86 chunks, most boundaries inside a leaf
PARTITION_BYTES = 4096
# top-k: 12,800 f32 elements a chunk, so ratio 0.01 tiles as (1, 100)
TOPK_PARTITION_BYTES = 51_200
JCFG, TCFG = JConfig.tiny(), GPTConfig.tiny()
B, S = 4, 32


@pytest.fixture(scope="module")
def init():
    jp = j_init(jax.random.PRNGKey(0), JCFG)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, JCFG.vocab_size, (B, S + 1)).astype(np.int32)
    return jax.tree.map(np.asarray, jp), toks[:, :-1], toks[:, 1:]


def _port_params(tree):
    return params_from_numpy(tree, TCFG, device="cpu")


def _ref_leaves(tree):
    """The reference tree's leaves in ``jax.tree.flatten`` order."""
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_flat_leaves_follow_tree_flatten_order(init):
    tree, _, _ = init
    got = [t.detach().numpy() for t in flat_leaves(_port_params(tree))]
    want = _ref_leaves(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    back = params_to_numpy(_port_params(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for g, w in zip(_ref_leaves(back), want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "dense"])
@pytest.mark.parametrize("remat", [False, True], ids=["keep", "remat"])
def test_loss_and_grad_match_reference(init, chunked, remat):
    tree, tok, tgt = init
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, a, b: j_loss(p, a, b, JCFG, remat=remat,
                               chunked_ce=chunked)))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(tok), jnp.asarray(tgt))
    params = _port_params(tree)
    params.requires_grad_(True)
    loss = gpt_loss(params, torch.as_tensor(tok).long(),
                    torch.as_tensor(tgt).long(), TCFG, remat=remat,
                    chunked_ce=chunked)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL,
                               atol=TOL)
    got = [t.grad.numpy() for t in flat_leaves(params)]
    for g, w in zip(got, _ref_leaves(jg)):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def _ref_run(tree, tok, tgt, compression, steps,
             partition_bytes=PARTITION_BYTES):
    mesh = make_mesh(MeshAxes(dp=1), devices=jax.devices()[:1])
    step, params, opt_state, bsh = j_train_step(
        JCFG, mesh, optax.adamw(1e-3), compression_params=compression,
        partition_bytes=partition_bytes,
        init_params=jax.tree.map(jnp.array, tree))
    tok, tgt = jax.device_put(tok, bsh), jax.device_put(tgt, bsh)
    losses, efs = [], []
    for _ in range(steps):
        loss, params, opt_state = step(params, opt_state, tok, tgt)
        losses.append(float(loss))
        efs.append(None if opt_state.ef is None
                   else np.asarray(opt_state.ef).reshape(-1))
    return losses, _ref_leaves(params), efs


def _port_run(tree, tok, tgt, compression, steps,
              partition_bytes=PARTITION_BYTES):
    step, params, opt = make_gpt_train_step(
        TCFG, compression_params=compression,
        partition_bytes=partition_bytes, init_params=_port_params(tree),
        device="cpu")
    losses, efs = [], []
    for _ in range(steps):
        losses.append(float(step(tok, tgt)))
        efs.append(None if opt.ef is None else opt.ef.numpy().copy())
    return losses, [t.detach().numpy() for t in flat_leaves(params)], efs


def test_raw_trajectory_matches_reference(init):
    tree, tok, tgt = init
    jl, jp, _ = _ref_run(tree, tok, tgt, None, 3)
    tl, tp, _ = _port_run(tree, tok, tgt, None, 3)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert tl[-1] < tl[0]
    for g, w in zip(tp, jp):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("momentum", [False, True],
                         ids=["ef", "ef-nesterov"])
def test_onebit_ef_trajectory_matches_reference(init, momentum):
    tree, tok, tgt = init
    comp = {"compressor": "onebit", "ef": "vanilla"}
    if momentum:
        comp["momentum"] = "nesterov"
    jl, jp, je = _ref_run(tree, tok, tgt, comp, 3)
    tl, tp, te = _port_run(tree, tok, tgt, comp, 3)
    np.testing.assert_allclose(tl, jl, rtol=ONEBIT_LOSS_TOL,
                               atol=ONEBIT_LOSS_TOL)
    assert tl[-1] < tl[0]
    assert te[0].shape == je[0].shape and np.abs(te[0]).max() > 0
    paths, _ = jax.tree_util.tree_flatten_with_path(tree)
    keep = np.concatenate([
        np.full(np.asarray(v).size, jax.tree_util.keystr(k)[-6:] != "['bk']")
        for k, v in paths])
    assert 0 < (~keep).sum() < 0.01 * keep.size
    np.testing.assert_allclose(te[0][keep], je[0][keep], rtol=TOL, atol=TOL)
    got, want = np.concatenate([g.ravel() for g in tp]), \
        np.concatenate([w.ravel() for w in jp])
    off = np.abs(got - want) > TOL + TOL * np.abs(want)
    assert off.mean() < ONEBIT_OFF_SHARE, (off.mean(), off.sum())


def test_topk_block_ef_trajectory_matches_reference(init):
    """topk-block + EF, the reference's own GPT-2 medium codec (ratio
    0.01), with 51,200-byte partitions: six full 12,800-element chunks on
    the tiled (1, 100) layout (the fused round trip) and a ragged
    10,752-element tail on the strided (101, 107) layout (select with
    its length, then reconstruct-sum). The support is chosen by exact
    comparisons of gradients that agree to ~1e-7, so both frameworks keep
    the same winners and the trajectory holds at the raw step's 1e-5."""
    from byteps_tpu_torch.compression.topk import block_shape, tiled_shape

    tree, tok, tgt = init
    comp = {"compressor": "topk", "k": 0.01, "ef": "vanilla",
            "selection": "block"}
    total = sum(int(np.asarray(v).size) for v in jax.tree.leaves(tree))
    chunk = TOPK_PARTITION_BYTES // 4
    tail = total % chunk
    assert total // chunk == 6 and tiled_shape(0.01, chunk) == (1, 100)
    assert tiled_shape(0.01, tail) is None
    rows, block = block_shape(0.01, tail)
    assert rows * block > tail                      # ragged
    jl, jp, je = _ref_run(tree, tok, tgt, comp, 3, TOPK_PARTITION_BYTES)
    tl, tp, te = _port_run(tree, tok, tgt, comp, 3, TOPK_PARTITION_BYTES)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert tl[-1] < tl[0]
    for t, j in zip(te, je):
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
    # one winner per group kept: the residual is nonzero almost everywhere
    assert np.count_nonzero(te[0]) > 0.9 * total
    for g, w in zip(tp, jp):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_chunked_ce_row_blocks_match_reference():
    """The fused readout + CE over several row blocks (the training
    shape runs 32 of them; the tiny model's batch fits one), value and
    gradients, against the reference's at the same blocking."""
    rng = np.random.default_rng(5)
    h = rng.standard_normal((4, 24, 32)).astype(np.float32)
    head = (0.1 * rng.standard_normal((32, 200))).astype(np.float32)
    tgt = rng.integers(0, 200, (4, 24))
    w = rng.random((4, 24)).astype(np.float32)

    def j_loss(h, head):
        return (j_chunked_ce(h, head, jnp.asarray(tgt), row_block=16)
                * w).sum()

    jl, (jdh, jdw) = jax.value_and_grad(j_loss, (0, 1))(jnp.asarray(h),
                                                        jnp.asarray(head))
    th, tw = (torch.as_tensor(a).requires_grad_() for a in (h, head))
    nll = chunked_ce_nll(th, tw, torch.as_tensor(tgt), row_block=16)
    (nll * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(float((nll.detach() * torch.as_tensor(w))
                                     .sum()), float(jl), rtol=TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=TOL,
                               atol=TOL)


def test_entry_point_contract():
    step, params, opt = make_gpt_train_step(
        TCFG, generator=torch.Generator().manual_seed(0), device="cpu")
    assert all(t.requires_grad and t.dtype == torch.float32
               for t in flat_leaves(params))
    assert opt.ef is None and opt.momentum is None
    tok, tgt = synthetic_batch(torch.Generator().manual_seed(1), TCFG, 2, 16)
    assert tok.shape == tgt.shape == (2, 16)
    assert torch.equal(tok[:, 1:], tgt[:, :-1])
    loss = step(tok, tgt)
    assert loss.ndim == 0 and torch.isfinite(loss)
    with pytest.raises(ValueError, match="init_params live on"):
        make_gpt_train_step(TCFG, init_params=params, device="meta")


_RING_RANK = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from byteps_tpu_torch.common.config import reset_config
from byteps_tpu_torch.models import (GPTConfig, flat_leaves, gpt_init,
                                     make_gpt_train_step)

rank, world, store_path, io = int(sys.argv[1]), int(sys.argv[2]), \
    sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)
PARTITION_BYTES = {pb}
cfg = GPTConfig.tiny()
toks = np.random.default_rng(20 + rank).integers(0, cfg.vocab_size, (4, 33))
out = {}
for tier in ("staged", "ring"):
    os.environ["BYTEPS_ICI_TIER"] = tier
    reset_config()
    step, params, opt = make_gpt_train_step(
        cfg, compression_params={"compressor": "onebit", "ef": "vanilla"},
        partition_bytes=PARTITION_BYTES,
        init_params=gpt_init(cfg, torch.Generator().manual_seed(0),
                             device="cpu"), device="cpu")
    out[tier + "_loss"] = np.array([float(step(toks[:, :-1], toks[:, 1:]))
                                    for _ in range(3)])
    out[tier + "_params"] = np.concatenate(
        [t.detach().numpy().ravel() for t in flat_leaves(params)])
    out[tier + "_ef"] = opt.ef.numpy()
np.savez(f"{io}/out{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
print(json.dumps({"rank": rank, "ok": True}))
"""


def test_two_ranks_ring_onebit_ef_trajectory_equals_staged(tmp_path):
    """Two gloo ranks train the tiny GPT 3 steps with onebit + EF on each
    tier, from the same weights and each rank's own batch, 4096-byte
    partitions (86 chunks a step): the ring's losses, parameters and EF
    residuals equal the staged tier's bit for bit, and both ranks hold the
    same parameters."""
    from test_torch_ring import run_group

    outs = run_group(tmp_path, 2,
                     _RING_RANK.replace("{pb}", str(PARTITION_BYTES)))
    for o in outs:
        for k in ("loss", "params", "ef"):
            np.testing.assert_array_equal(o[f"ring_{k}"], o[f"staged_{k}"])
        assert np.isfinite(o["ring_loss"]).all()
        assert o["ring_loss"][-1] < o["ring_loss"][0]
    np.testing.assert_array_equal(outs[0]["ring_params"],
                                  outs[1]["ring_params"])
    np.testing.assert_array_equal(outs[0]["ring_loss"], outs[1]["ring_loss"])
    assert not np.array_equal(outs[0]["ring_ef"], outs[1]["ring_ef"])
