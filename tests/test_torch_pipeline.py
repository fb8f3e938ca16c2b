"""The port's pipeline parallelism against the reference's, on the CPU in
f32, from the reference's own weights.

The reference runs on a mesh of the conftest's CPU devices; the port
runs the same mesh as gloo rank processes (``tests/helpers/
pp_moe_rank.py``, each group once a test session):

* ``pipeline_apply`` of a tanh layer stack, with and without aux, on pp2
  and pp4: the last stage's outputs, each stage's aux and loss, and the
  gradients of each stage's slab and of the input, within the
  reference's own rtol 1e-4 / atol 1e-6 (``tests/test_pipeline.py``);
* ``make_gpt_pp_train_step``, 3 steps from ``gpt_init``'s weights on a
  global batch of 8 × 32: pp2×dp2 (2 microbatches), a 4-layer pp2 (2
  layers a stage, 4 microbatches), pp2×tp2, pp2×sp2 contiguous and
  zigzag, the llama options on pp2×dp2: losses and the gathered
  parameters within 1e-5 of the reference's step in its explicit
  gradient assembly (its default raw path over-counts the leaves every
  stage holds: ROADMAP C, held by a test below), both under SGD (lr 0.5
  on both sides: a parameter moves by lr·g, so a gradient wrong by 2e-5
  shows; AdamW's ``g / (|g| + 1e-8)`` would turn each library's
  summation order into up to 1e-5 at a near-zero gradient); remat on
  and off bit-equal;
* ZeRO-1 over each stage's dp line on pp2×dp2 (SGD): within 1e-5 of the
  reference's ``zero_1=True`` step and bit-equal to the port's
  replicated pp2×dp2 step;
* dp2×pp2 onebit + EF (AdamW): losses within 1e-4 of the reference's and
  a share under 1e-3 of the parameters further than 1e-5 from its (PR
  19's onebit bounds) on every leaf but the key bias, whose exact
  gradient is zero (its elements within their sign noise, 2·lr a step);
  each rank against the reference's device of the same index (each
  stage's aggregate of the leaves every stage holds is its own under a
  lossy codec, in both packages);
* the raw legs' parameters, the stage-replicated leaves included, are
  bit-identical on every rank; the collectives a leg issues are the
  schedule's (M + S − 2 shifts each way a step);
* the refusals, with the reference's messages.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from pp_moe_parity import (SGD_LR, assert_onebit_held,  # noqa: E402
                           batch, fake_mesh, j_mesh, jnp_tree, leg_ranks,
                           leaf_names, port_groups, ref_train, tree_leaves)
from train_parity import (ONEBIT_EF, ONEBIT_LOSS_TOL,  # noqa: E402
                          TOL, llama_cfg)

from byteps_tpu.models import GPTConfig as JConfig  # noqa: E402
from byteps_tpu.models.gpt import gpt_init as j_init  # noqa: E402
from byteps_tpu.models.train import make_gpt_pp_train_step as j_pp_step  # noqa: E402,E501
from byteps_tpu.parallel.pipeline import pipeline_apply as j_pipeline  # noqa: E402,E501
from byteps_tpu.parallel.pipeline import stacked_specs as j_stacked_specs  # noqa: E402,E501
from byteps_tpu_torch.models import GPTConfig  # noqa: E402
from byteps_tpu_torch.parallel.mesh import collectives  # noqa: E402

torch.set_num_threads(1)
PIPE_RTOL, PIPE_ATOL = 1e-4, 1e-6     # the reference's pipeline bounds
L, D, M, MB = 8, 16, 6, 2              # layers, width, microbatches, rows
TREES = {"tiny": ({}, False), "tiny4": ({"n_layers": 4}, False),
         "llama": (llama_cfg(), True)}
LEGS = {
    2: [{"name": "pipe2", "kind": "pipeline", "mesh": {"pp": 2}},
        {"name": "pipe2_aux", "kind": "pipeline", "mesh": {"pp": 2},
         "aux": True},
        {"name": "pp2_4layer", "kind": "pp_train", "mesh": {"pp": 2},
         "tree": "tiny4", "cfg": {"n_layers": 4}, "kw": {"n_micro": 4}}],
    4: [{"name": "pipe4", "kind": "pipeline", "mesh": {"pp": 4}},
        {"name": "pipe4_aux", "kind": "pipeline", "mesh": {"pp": 4},
         "aux": True},
        {"name": "pp2_dp2", "kind": "pp_train", "mesh": {"pp": 2, "dp": 2},
         "tree": "tiny", "kw": {"n_micro": 2}},
        {"name": "pp2_dp2_remat", "kind": "pp_train",
         "mesh": {"pp": 2, "dp": 2}, "tree": "tiny",
         "kw": {"n_micro": 2, "remat": True}},
        {"name": "pp2_tp2", "kind": "pp_train", "mesh": {"pp": 2, "tp": 2},
         "tree": "tiny", "kw": {"n_micro": 2}},
        {"name": "pp2_sp2", "kind": "pp_train", "mesh": {"pp": 2, "sp": 2},
         "tree": "tiny", "kw": {"n_micro": 2}},
        {"name": "pp2_sp2_zigzag", "kind": "pp_train",
         "mesh": {"pp": 2, "sp": 2}, "tree": "tiny", "zigzag": True,
         "kw": {"n_micro": 2, "seq_layout": "zigzag"}},
        {"name": "pp2_dp2_llama", "kind": "pp_train",
         "mesh": {"pp": 2, "dp": 2}, "tree": "llama", "llama": True,
         "cfg": llama_cfg(), "kw": {"n_micro": 2}},
        {"name": "dp2_pp2_onebit_ef", "kind": "pp_train",
         "mesh": {"pp": 2, "dp": 2}, "tree": "tiny",
         "kw": {"n_micro": 2, "compression_params": ONEBIT_EF}},
        {"name": "pp2_dp2_zero1", "kind": "pp_train",
         "mesh": {"pp": 2, "dp": 2}, "tree": "tiny",
         "kw": {"n_micro": 2, "zero_1": True}}],
}
RAW = ["pp2_dp2", "pp2_4layer", "pp2_tp2", "pp2_sp2", "pp2_sp2_zigzag",
       "pp2_dp2_llama"]
for _g in LEGS[2] + LEGS[4]:
    if _g["name"] in RAW + ["pp2_dp2_remat", "pp2_dp2_zero1"]:
        _g.update(opt="sgd", lr=SGD_LR)


def _jcfg(tree: str):
    kw, llama = TREES[tree]
    return (JConfig.llama(**kw) if llama
            else JConfig(**{**JConfig.tiny().__dict__, **kw}))


def _trees():
    return {t: jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0),
                                               _jcfg(t)))
            for t in TREES}


def _pipe_arrays():
    rng = np.random.RandomState(0)
    return {"pipe_w": (rng.randn(L, D, D) * 0.2).astype(np.float32),
            "pipe_b": (rng.randn(L, D) * 0.1).astype(np.float32),
            "pipe_x": rng.randn(M, MB, D).astype(np.float32)}


@pytest.fixture(scope="module")
def data():
    trees = _trees()
    tok, tgt = batch()
    arrays = {"tok": tok, "tgt": tgt, **_pipe_arrays()}
    for t, tree in trees.items():
        arrays.update({f"{t}_p{i}": a
                       for i, a in enumerate(tree_leaves(tree))})
    return trees, tok, tgt, arrays


@pytest.fixture(scope="module")
def port(data, tmp_path_factory):
    return port_groups("torch_pipeline", LEGS, data[3], tmp_path_factory)


def _ranks(port, leg):
    return leg_ranks(port, LEGS, leg)


def _leg(name):
    return next(g for legs in LEGS.values() for g in legs
                if g["name"] == name)


# --------------------------------------------------------------------------
# pipeline_apply
# --------------------------------------------------------------------------
def _ref_pipeline(n: int, aux_on: bool):
    """The reference's pipeline_apply on pp = n, per device: (outs, aux,
    loss, dx) stacked over the stages, and the slab gradients."""
    a = _pipe_arrays()
    stacked = {"w": jnp.asarray(a["pipe_w"]), "b": jnp.asarray(a["pipe_b"])}
    x_mb = jnp.asarray(a["pipe_x"])

    def blk(x, p):
        h = jnp.tanh(x @ p["w"] + p["b"])
        return (h, (h ** 2).mean()) if aux_on else h

    def loss_fn(st, x):
        res = j_pipeline(x, st, blk, "pp", has_aux=aux_on)
        outs, aux = res if aux_on else (res, jnp.zeros(()))
        stage = jax.lax.axis_index("pp")
        loss = jnp.where(stage == n - 1, (outs ** 2).mean(), 0.0)
        if aux_on:
            loss = loss + 0.01 * aux
        return loss, (outs, aux)

    def per_device(st, x):
        (loss, (outs, aux)), (gst, gx) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(st, x)
        return outs[None], aux[None], loss[None], gx[None], gst

    mesh = j_mesh({"pp": n})
    specs = j_stacked_specs({"w": P(), "b": P()}, "pp")
    st = jax.device_put(stacked, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs))
    outs, aux, loss, gx, gst = jax.jit(jax.shard_map(
        per_device, mesh=mesh, in_specs=(specs, P()),
        out_specs=(P("pp"), P("pp"), P("pp"), P("pp"), specs),
        check_vma=False))(st, x_mb)
    return [np.asarray(v) for v in (outs, aux, loss, gx)], \
        jax.tree.map(np.asarray, gst)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("aux_on", [False, True], ids=["plain", "aux"])
def test_pipeline_apply_matches_reference(port, n, aux_on):
    (outs, aux, loss, gx), gst = _ref_pipeline(n, aux_on)
    name = f"pipe{n}" + ("_aux" if aux_on else "")
    ranks = _ranks(port, name)
    rows = L // n
    kw = dict(rtol=PIPE_RTOL, atol=PIPE_ATOL)
    for s, o in enumerate(ranks):
        np.testing.assert_allclose(o[f"{name}_outs"], outs[s], **kw)
        np.testing.assert_allclose(o[f"{name}_aux"], aux[s], **kw)
        np.testing.assert_allclose(o[f"{name}_loss"], loss[s], **kw)
        np.testing.assert_allclose(o[f"{name}_dx"], gx[s], **kw)
        np.testing.assert_allclose(o[f"{name}_dw"],
                                   gst["w"][s * rows:(s + 1) * rows], **kw)
        np.testing.assert_allclose(o[f"{name}_db"],
                                   gst["b"][s * rows:(s + 1) * rows], **kw)
    # the outputs are the last stage's, zeros elsewhere; last_stage_value
    # gives every stage the last stage's
    assert np.abs(ranks[-1][f"{name}_outs"]).max() > 0
    for o in ranks[:-1]:
        assert not o[f"{name}_outs"].any()
    for o in ranks:
        np.testing.assert_array_equal(o[f"{name}_last"],
                                      ranks[-1][f"{name}_outs"])


# --------------------------------------------------------------------------
# make_gpt_pp_train_step
# --------------------------------------------------------------------------
def _ref_pp(data, name, explicit=True, steps=3):
    """The reference's ``make_gpt_pp_train_step`` for a leg. ``explicit``:
    its explicit gradient assembly (``check_vma=False``, the path every
    compressed step takes; a raw leg reaches it through the identity
    codec, ``compression_params={}``). Its default raw path over-counts
    the stage-replicated leaves (:func:`test_reference_vma_pp_step_
    overcounts_the_stage_replicated_leaves`)."""
    leg = _leg(name)
    trees, tok, tgt, _ = data
    kw = dict(leg["kw"])
    if explicit:
        kw.setdefault("compression_params", {})
    if leg.get("zigzag"):
        from byteps_tpu.parallel import zigzag_permutation
        perm = np.asarray(zigzag_permutation(tok.shape[1], 2))
        tok, tgt = tok[:, perm], tgt[:, perm]
    return ref_train(j_pp_step, _jcfg(leg["tree"]), leg["mesh"], tok, tgt,
                     steps=steps, stacked=True, opt=leg.get("opt", "adamw"),
                     init_params=jnp_tree(trees[leg["tree"]]), **kw)


@pytest.mark.parametrize("leg", RAW)
def test_pp_step_matches_reference(port, data, leg):
    losses, views = _ref_pp(data, leg)
    for r, o in enumerate(_ranks(port, leg)):
        np.testing.assert_allclose(o[f"{leg}_loss"], losses, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(o[f"{leg}_params"], views[r], rtol=TOL,
                                   atol=TOL)


def test_pp_zero1_over_dp_matches_reference(port, data):
    """ZeRO-1 over each stage's dp line (each stage shards its own slab's
    state): within 1e-5 of the reference's ``zero_1=True`` step (its
    explicit gradient assembly), and bit-equal to the port's replicated
    pp2×dp2 step (the scatter and the all-reduce add the same two dp
    terms; SGD is elementwise)."""
    leg = "pp2_dp2_zero1"
    losses, views = _ref_pp(data, leg)
    for r, (o, q) in enumerate(zip(_ranks(port, leg),
                                   _ranks(port, "pp2_dp2"))):
        np.testing.assert_allclose(o[f"{leg}_loss"], losses, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(o[f"{leg}_params"], views[r], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(o[f"{leg}_loss"], q["pp2_dp2_loss"])
        np.testing.assert_array_equal(o[f"{leg}_params"],
                                      q["pp2_dp2_params"])


def test_pp_onebit_ef_matches_reference(port, data):
    leg = "dp2_pp2_onebit_ef"
    losses, views = _ref_pp(data, leg)
    names = leaf_names(data[0]["tiny"])
    for r, o in enumerate(_ranks(port, leg)):
        np.testing.assert_allclose(o[f"{leg}_loss"], losses,
                                   rtol=ONEBIT_LOSS_TOL,
                                   atol=ONEBIT_LOSS_TOL)
        assert_onebit_held(o[f"{leg}_params"], views[r], names)


def test_reference_vma_pp_step_overcounts_the_stage_replicated_leaves(
        port, data):
    """A fault of the reference (ROADMAP C): its raw ``check_vma=True``
    pp step sums the gradients of the leaves every stage holds over pp
    twice (VMA's own sum, then ``_manual_axis_sums`` over pp), so one SGD
    step moves them pp times as far as its explicit path does; the slab
    moves alike. AdamW's scale invariance hides it but where a gradient
    is near Adam's ε. The port's step is the explicit path's."""
    tree = data[0]["tiny"]
    names = leaf_names(tree)
    p0 = np.concatenate([np.ravel(a) for a in tree_leaves(tree)])
    _, vma = _ref_pp(data, "pp2_dp2", explicit=False, steps=1)
    _, exp = _ref_pp(data, "pp2_dp2", steps=1)
    rep = np.isin(names, [".wte", ".wpe", ".lnf_g", ".lnf_b"])
    np.testing.assert_allclose(vma[0][rep] - p0[rep],
                               2 * (exp[0][rep] - p0[rep]), rtol=1e-3,
                               atol=1e-7)
    np.testing.assert_allclose(vma[0][~rep], exp[0][~rep], rtol=TOL,
                               atol=TOL)
    # the port after one step: its step-3 parameters are held above; its
    # first loss after an update sits with the explicit path
    losses, _ = _ref_pp(data, "pp2_dp2", explicit=False)
    got = _ranks(port, "pp2_dp2")[0]["pp2_dp2_loss"]
    assert abs(got[1] - losses[1]) > 1e-2


def test_pp_remat_is_bit_equal(port):
    for o in _ranks(port, "pp2_dp2"):
        np.testing.assert_array_equal(o["pp2_dp2_remat_loss"],
                                      o["pp2_dp2_loss"])
        np.testing.assert_array_equal(o["pp2_dp2_remat_params"],
                                      o["pp2_dp2_params"])


@pytest.mark.parametrize("leg", RAW + ["pp2_dp2_remat"])
def test_pp_params_bit_identical_across_ranks(port, leg):
    """Every rank ends with the same bits of every leaf, the leaves every
    stage holds (its own copy) included."""
    outs = _ranks(port, leg)
    for o in outs[1:]:
        np.testing.assert_array_equal(o[f"{leg}_loss"],
                                      outs[0][f"{leg}_loss"])
        np.testing.assert_array_equal(o[f"{leg}_params"],
                                      outs[0][f"{leg}_params"])


@pytest.mark.parametrize("leg,ticks", [("pp2_dp2", 2 + 2 - 2),
                                       ("pp2_4layer", 4 + 2 - 2),
                                       ("pp2_sp2", 2 + 2 - 2)])
def test_pp_collectives_follow_the_schedule(port, leg, ticks):
    """M + S − 2 shifts each way and one pp gradient sum a step; with sp,
    one sp rotation each way a layer and microbatch, and one sp sum."""
    kinds = list(collectives)
    steps = 3
    for o in _ranks(port, leg):
        got = dict(zip(kinds, o[f"{leg}_collectives"].tolist()))
        assert got["pp_shift_fwd"] == got["pp_shift_bwd"] == steps * ticks
        assert got["pp_grad_sum"] == steps
        if leg == "pp2_sp2":
            # 2 microbatches a stage, 1 layer a stage, sp = 2: one rotation
            assert got["sp_rotate_fwd"] == got["sp_rotate_bwd"] == steps * 2
            assert got["sp_grad_sum"] == steps


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------
def test_pp_refusals():
    """The reference's errors: no pp axis, layers that pp does not
    divide, a batch that the microbatches do not divide."""
    from byteps_tpu_torch.models import make_gpt_pp_train_step

    cfg = GPTConfig.tiny()
    with pytest.raises(ValueError, match="mesh has no pp axis"):
        make_gpt_pp_train_step(cfg, fake_mesh({"dp": 2}, 0), device="cpu")
    with pytest.raises(ValueError, match="mesh has no pp axis"):
        make_gpt_pp_train_step(cfg, None, device="cpu")
    three = GPTConfig(**{**cfg.__dict__, "n_layers": 3})
    with pytest.raises(ValueError, match="n_layers=3 not divisible by pp=2"):
        make_gpt_pp_train_step(three, fake_mesh({"pp": 2}, 0),
                               device="cpu")
    with pytest.raises(ValueError, match="requires a mesh with an sp axis"):
        make_gpt_pp_train_step(cfg, fake_mesh({"pp": 2}, 0), device="cpu",
                               seq_layout="zigzag")
    step, _, _ = make_gpt_pp_train_step(cfg, fake_mesh({"pp": 2}, 1),
                                        device="cpu", n_micro=3)
    tok = np.zeros((4, 8), np.int64)
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        step(tok, tok)
