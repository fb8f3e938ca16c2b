"""The port's ZeRO-3 FSDP (``parallel/zero3.py``,
``make_gpt_train_step(zero_3=True)``) against the reference's
``byteps_tpu/parallel/zero3.py``, on the CPU in f32, from the
reference's own weights.

* The segment layout: ``_group_meta`` and ``_to_segs`` (the ``rest``
  group and one group a block, each flattened in the reference's leaf
  order and zero-padded to a multiple of ``n_shard``) bit-equal to the
  reference's at n_shard 1, 2 and 3, on ``GPTConfig.tiny()`` and on a
  tiny llama (untied head, no biases, RMSNorm); the segment converter
  (``models.convert.zero3_segments_from_numpy``) cuts the reference's
  segments into n_shard pieces that join back to them bit for bit.
* ``zero3_gather_params`` on numpy segments equals the reference's bit
  for bit (it only cuts and reshapes).
* The step on gloo rank processes (``tests/helpers/multislice_rank.py``)
  against the reference's ``make_gpt_zero3_train_step`` on (slice_=2,
  dp=2), (dp=4) and (slice_=2), ``remat=True``, two AdamW steps: the
  losses and each group's whole segments (gathered back with
  ``zero3_segments_to_numpy``) and the parameters rebuilt from them
  within 1e-5 (f32 roundoff: the reduce-scatter and the dp sum add in
  gloo's order, the reference's ``psum_scatter`` in XLA's); every
  rank's first segments bit-equal to the converter's cut of the
  reference's initial segments.
* ``remat=True`` bit-equal to ``remat=False`` (the same forward, run
  again). One rank without a mesh bit-equal to the port's replicated
  step (the gather and scatter are identities there).
* Persistent bytes a rank: the segments and AdamW's two moments, exactly
  ``3·4·(seg_rest + n_layers·seg_block)``; GPT-2 medium at n_shard 2 is
  2,129,227,776 B, against 4,258,455,552 replicated.
* The collectives a step: one forward gather a group, one backward
  gather a block under remat, one reduce-scatter a group, one sum over
  dp under a ``slice_`` shard.
* The refusals with the reference's messages (``tests/test_multislice.py``
  ``test_zero3_rejects_bad_compositions``), and ``accum_steps``.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from pp_moe_parity import (batch, fake_mesh, j_mesh, jnp_tree,  # noqa: E402
                           leg_ranks, port_groups, tree_leaves)
from train_parity import TOL, llama_cfg  # noqa: E402

from byteps_tpu.models import GPTConfig as JConfig  # noqa: E402
from byteps_tpu.models.gpt import gpt_init as j_init  # noqa: E402
from byteps_tpu.models.train import make_gpt_train_step as j_train_step  # noqa: E402,E501
from byteps_tpu.parallel import zero3 as jz3  # noqa: E402
from byteps_tpu_torch.models import (GPTConfig, flat_leaves,  # noqa: E402
                                     make_gpt_train_step, params_from_numpy)
from byteps_tpu_torch.models.convert import (  # noqa: E402
    zero3_segments_from_numpy)
from byteps_tpu_torch.parallel import zero3 as tz3  # noqa: E402
from byteps_tpu_torch.parallel.mesh import collectives  # noqa: E402

torch.set_num_threads(1)
STEPS = 2
CFGS = {"tiny": ({}, False), "llama": (llama_cfg(), True)}
MESHES = {"z3_s2dp2": {"slice_": 2, "dp": 2}, "z3_dp4": {"dp": 4},
          "z3_s2": {"slice_": 2}}
LEGS = {
    4: [{"name": "z3_s2dp2", "kind": "zero3", "mesh": MESHES["z3_s2dp2"],
         "tree": "tiny", "steps": STEPS, "kw": {"remat": True}},
        {"name": "z3_s2dp2_noremat", "kind": "zero3",
         "mesh": MESHES["z3_s2dp2"], "tree": "tiny", "steps": STEPS},
        {"name": "z3_dp4", "kind": "zero3", "mesh": MESHES["z3_dp4"],
         "tree": "tiny", "steps": STEPS, "kw": {"remat": True}}],
    2: [{"name": "z3_s2", "kind": "zero3", "mesh": MESHES["z3_s2"],
         "tree": "tiny", "steps": STEPS, "kw": {"remat": True}}],
}


def _jcfg(name):
    kw, llama = CFGS[name]
    return JConfig.llama(**kw) if llama else JConfig.tiny()


def _tcfg(name):
    kw, llama = CFGS[name]
    return GPTConfig.llama(**kw) if llama else GPTConfig.tiny()


def _tree(name):
    return jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0),
                                           _jcfg(name)))


def _segs_np(segs) -> dict:
    return {"rest": np.asarray(segs["rest"]),
            "blocks": [np.asarray(b) for b in segs["blocks"]]}


@pytest.fixture(scope="module")
def data():
    tree = _tree("tiny")
    tok, tgt = batch()
    arrays = {"tok": tok, "tgt": tgt}
    arrays.update({f"tiny_p{i}": a for i, a in enumerate(tree_leaves(tree))})
    return tree, tok, tgt, arrays


@pytest.fixture(scope="module")
def port(data, tmp_path_factory):
    return port_groups("torch_zero3", LEGS, data[3], tmp_path_factory,
                       script="multislice_rank.py")


# --------------------------------------------------------------------------
# the segment layout, the converter, the host-side gather
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cfg", list(CFGS))
@pytest.mark.parametrize("n_shard", [1, 2, 3])
def test_segment_layout_bit_equal_to_reference(cfg, n_shard):
    tree = _tree(cfg)
    want = jz3._to_segs(jax.tree.map(jnp.asarray, tree), n_shard)
    (_, r_sizes, r_total, r_pad), (_, b_sizes, b_total, b_pad) = \
        jz3._group_meta(tree, n_shard)
    port = params_from_numpy(tree, _tcfg(cfg), device="cpu")
    for params in (port, tree):       # a GPT, or the reference's tree
        got = tz3._to_segs(params, n_shard)
        np.testing.assert_array_equal(got["rest"].numpy(), want["rest"])
        assert len(got["blocks"]) == len(want["blocks"])
        for g, w in zip(got["blocks"], want["blocks"]):
            np.testing.assert_array_equal(g.numpy(), w)
    (_, _, rs, rt, rp), (_, _, bs, bt, bp) = tz3._group_meta(port, n_shard)
    assert (rs, rt, rp) == (r_sizes, r_total, r_pad)
    assert (bs, bt, bp) == (b_sizes, b_total, b_pad)
    assert rp % n_shard == 0 and bp % n_shard == 0


@pytest.mark.parametrize("n_shard", [1, 2, 3])
def test_segment_converter_cuts_and_joins_bit_for_bit(n_shard):
    want = _segs_np(jz3._to_segs(jax.tree.map(jnp.asarray, _tree("tiny")),
                                 n_shard))
    cuts = [zero3_segments_from_numpy(want, n_shard, i, device="cpu")
            for i in range(n_shard)]
    np.testing.assert_array_equal(
        np.concatenate([c["rest"].numpy() for c in cuts]), want["rest"])
    for b, w in enumerate(want["blocks"]):
        np.testing.assert_array_equal(
            np.concatenate([c["blocks"][b].numpy() for c in cuts]), w)
        assert {c["blocks"][b].numel() for c in cuts} == {w.size // n_shard}


@pytest.mark.parametrize("cfg", list(CFGS))
def test_gather_params_bit_equal_to_reference(cfg):
    jcfg = _jcfg(cfg)
    shapes = jz3._to_segs(jax.tree.map(jnp.asarray, _tree(cfg)), 2)
    rng = np.random.default_rng(5)
    segs = {"rest": rng.standard_normal(shapes["rest"].shape)
            .astype(np.float32),
            "blocks": [rng.standard_normal(b.shape).astype(np.float32)
                       for b in shapes["blocks"]]}
    want = [np.asarray(x) for x in
            jax.tree.leaves(jz3.zero3_gather_params(segs, jcfg))]
    got = tz3.zero3_gather_params(segs, _tcfg(cfg))
    assert got.wte.device.type == "cpu"
    leaves = flat_leaves(got)
    assert len(leaves) == len(want)
    for g, w in zip(leaves, want):
        np.testing.assert_array_equal(g.detach().numpy(), w)


def test_persistent_bytes_gpt2_medium_arithmetic():
    """GPT-2 medium's groups at n_shard 2: 26,280,960 (rest) and 6,298,112
    (a block) f32 a rank; with AdamW's two moments 2,129,227,776 B, half
    the replicated 4,258,455,552 (params plus moments)."""
    cfg = GPTConfig.gpt2_medium()
    (_, _, _, rt, rp), (_, _, _, bt, bp) = tz3._group_meta(
        tz3._shapes_gpt(cfg), 2)
    assert (rp // 2, bp // 2) == (26_280_960, 6_298_112)
    assert 3 * 4 * (rp // 2 + cfg.n_layers * bp // 2) == 2_129_227_776
    assert 3 * 4 * (rt + cfg.n_layers * bt) == 4_258_455_552


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------
def _ref_zero3(data, name):
    """The reference's ZeRO-3 step (``optax.adamw(1e-3)``, remat) on the
    leg's mesh: (losses, whole numpy segments after the steps, the
    parameters they rebuild, flat; the initial segments)."""
    tree, tok, tgt, _ = data
    step, segs, opt_state, bsh = j_train_step(
        JConfig.tiny(), j_mesh(MESHES[name]), optax.adamw(1e-3),
        zero_3=True, remat=True, init_params=jnp_tree(tree))
    init = _segs_np(jax.tree.map(np.asarray, segs))
    a, b = jax.device_put(tok, bsh), jax.device_put(tgt, bsh)
    losses = []
    for _ in range(STEPS):
        loss, segs, opt_state = step(segs, opt_state, a, b)
        losses.append(float(loss))
    segs = _segs_np(jax.tree.map(np.asarray, segs))
    params = np.concatenate([np.asarray(x).ravel() for x in jax.tree.leaves(
        jz3.zero3_gather_params(segs, JConfig.tiny()))])
    return losses, segs, params, init


@pytest.mark.parametrize("name", list(MESHES))
def test_zero3_step_matches_reference(port, data, name):
    losses, segs, params, init = _ref_zero3(data, name)
    outs = leg_ranks(port, LEGS, name)
    n_shard = MESHES[name].get("slice_", MESHES[name].get("dp"))
    kw = dict(rtol=TOL, atol=TOL)
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o[f"{name}_loss"], losses, **kw)
        np.testing.assert_allclose(o[f"{name}_rest"], segs["rest"], **kw)
        for i, b in enumerate(segs["blocks"]):
            np.testing.assert_allclose(o[f"{name}_b{i}"], b, **kw)
        np.testing.assert_allclose(o[f"{name}_params"], params, **kw)
        # the first segments: the converter's cut of the reference's
        idx = r // (len(outs) // n_shard)        # the shard axis outermost
        cut = zero3_segments_from_numpy(init, n_shard, idx, device="cpu")
        np.testing.assert_array_equal(o[f"{name}_init_rest"],
                                      cut["rest"].numpy())
        for i, b in enumerate(cut["blocks"]):
            np.testing.assert_array_equal(o[f"{name}_init_b{i}"], b.numpy())
    for o in outs[1:]:
        np.testing.assert_array_equal(o[f"{name}_params"],
                                      outs[0][f"{name}_params"])


def test_zero3_remat_bit_equal(port):
    a = leg_ranks(port, LEGS, "z3_s2dp2")
    b = leg_ranks(port, LEGS, "z3_s2dp2_noremat")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["z3_s2dp2_loss"],
                                      y["z3_s2dp2_noremat_loss"])
        np.testing.assert_array_equal(x["z3_s2dp2_params"],
                                      y["z3_s2dp2_noremat_params"])


@pytest.mark.parametrize("name", list(MESHES))
def test_zero3_persistent_bytes(port, name):
    """Each rank holds its segment of every group and AdamW's two
    moments of it, nothing else: 3·4·(seg_rest + n_layers·seg_block)."""
    n_shard = MESHES[name].get("slice_", MESHES[name].get("dp"))
    (_, _, _, rt, rp), (_, _, _, bt, bp) = tz3._group_meta(
        tz3._shapes_gpt(GPTConfig.tiny()), n_shard)
    want = 3 * 4 * (rp // n_shard + GPTConfig.tiny().n_layers * bp // n_shard)
    for o in leg_ranks(port, LEGS, name):
        assert int(o[f"{name}_bytes"]) == want
    # the reference's own bar: under 0.6 of the replicated 3P
    assert want < 0.6 * 3 * 4 * (rt + GPTConfig.tiny().n_layers * bt)


@pytest.mark.parametrize("name,bwd,dp_sum", [
    ("z3_s2dp2", 2, 1), ("z3_s2dp2_noremat", 0, 1), ("z3_dp4", 2, 0),
    ("z3_s2", 2, 0)])
def test_zero3_collectives(port, name, bwd, dp_sum):
    """A step: one gather a group forward (rest + 2 blocks), one again a
    block in a rematerialized backward, one reduce-scatter a group, and
    one sum of the segment gradients over dp under a slice_ shard."""
    for o in leg_ranks(port, LEGS, name):
        c = dict(zip(collectives, o[f"{name}_collectives"].tolist()))
        want = {"zero3_gather_fwd": 3, "zero3_gather_bwd": bwd,
                "zero3_reduce_scatter": 3, "zero3_grad_sum": dp_sum}
        assert {k: c[k] for k in want} == {k: v * STEPS
                                           for k, v in want.items()}
        assert sum(c.values()) == sum(want.values()) * STEPS


@pytest.mark.parametrize("remat", [False, True])
def test_zero3_one_rank_bit_equal_to_replicated(remat):
    """Without a mesh on one rank the gather and the scatter are
    identities: the same bits as the replicated step."""
    cfg = GPTConfig.tiny()
    tree = _tree("tiny")
    tok, tgt = batch()
    step, params, _ = make_gpt_train_step(
        cfg, init_params=params_from_numpy(tree, cfg, device="cpu"),
        device="cpu")
    want = [float(step(tok, tgt)) for _ in range(STEPS)]
    z, segs, _ = make_gpt_train_step(
        cfg, init_params=params_from_numpy(tree, cfg, device="cpu"),
        device="cpu", zero_3=True, remat=remat)
    assert [float(z(tok, tgt)) for _ in range(STEPS)] == want
    whole = {"rest": segs["rest"].detach(),
             "blocks": [b.detach() for b in segs["blocks"]]}
    for g, w in zip(flat_leaves(tz3.zero3_gather_params(whole, cfg)),
                    flat_leaves(params)):
        assert torch.equal(g, w.detach())


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kw,axes,match", [
    ({"zero_1": True, "zero_3": True}, {"slice_": 2, "dp": 2},
     "mutually exclusive"),
    ({"zero_3": True, "compression_params": {"compressor": "onebit"}},
     {"slice_": 2, "dp": 2}, "compose with zero_3"),
    ({"zero_3": True}, {"dp": 4, "tp": 2}, "pure FSDP"),
    ({"zero_1": True}, {"slice_": 2, "dp": 2}, "zero_3=True"),
], ids=["zero1-zero3", "compression", "tp", "zero1-slice"])
def test_zero3_refusals_match_reference(kw, axes, match):
    jmesh = j_mesh(axes)
    with pytest.raises(ValueError, match=match):
        j_train_step(JConfig.tiny(), jmesh, optax.adam(1e-2), **kw)
    with pytest.raises(ValueError, match=match):
        make_gpt_train_step(GPTConfig.tiny(), device="cpu",
                            mesh=fake_mesh(axes, 0), **kw)


def test_zero3_refuses_accumulation():
    with pytest.raises(ValueError, match="accum_steps"):
        make_gpt_train_step(GPTConfig.tiny(), device="cpu", zero_3=True,
                            accum_steps=2)
