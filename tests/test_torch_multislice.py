"""The port's multi-slice tier (the ``slice_`` axis as a hierarchical DCN
tier) and ZeRO-1 over a mesh's dp subgroup, against the reference, on
the CPU in f32, from the reference's own weights.

The reference runs on the conftest's CPU devices, the port as gloo rank
processes (``tests/helpers/multislice_rank.py``, each group once a test
session under a file lock):

* ``DistributedOptimizer(dcn_axis=)`` alone on (slice_=2, dp=2), SGD at
  lr 1 from zero, three steps of random gradient rows, against the
  reference's in ``shard_map`` (``tests/test_multislice.py``'s
  ``_hier_opt_step``): raw at a length that needs padding (13), and
  onebit, top-k and randomk with EF at 1,001 (padded to two dp segments
  of 501, chunked by 256 partition bytes). Each rank's parameter after
  every step, and its EF residual (segment-sized) against the reference
  device's block ``s·n_dp + d``. Exact for top-k, whose two-term sums
  (the dp reduce-scatter, the owner's sum over two slices) add alike in
  any order and whose selection and scale are the reference's bit for
  bit; exact for randomk given the reference's own draws (the port draws
  from ``torch.Generator``; each rank process is handed the reference's
  indices for every key it derives, as ``tests/test_torch_codecs.py``
  holds the codec); onebit within 1e-6 relative (its ``mean(|x|)``
  scales reduce in another order, ``tests/test_torch_ici.py``); raw
  within 1e-6 (a four-term sum over the joined group, gloo's order
  against XLA's).
* ``make_gpt_train_step`` on (slice_=2, dp=2) raw and onebit + EF, on
  (slice_=2) and on (slice_=2, tp=2); ``make_gpt_pp_train_step`` on
  (slice_=2, pp=2) (SGD, the reference's explicit gradient assembly,
  ROADMAP C); ``make_gpt_moe_train_step`` on (slice_=2, ep=2) (SGD);
  ``make_eval_step`` on (slice_=2, dp=2): losses and the gathered
  parameters within 1e-5 of the reference's (onebit: the onebit
  training bounds of ``assert_onebit_held``, the key bias held to its
  sign noise). The raw (slice_=2, dp=2)
  step is bit-equal to the port's dp=4 step: the joined group sums the
  same four gradients in one all-reduce over the whole job.
* ROADMAP C.1's own case on (slice_=2): both ranks end the step with
  bit-identical parameters (one sum over the slice axis) equal to the
  reference's within 1e-5, and every multi-slice leg's replicated
  parameters are bit-identical on every rank that holds them.
* ZeRO-1 over the dp subgroup of (dp=2, tp=2) and, for the MoE step,
  (dp=2, ep=2) (SGD): within 1e-5 of the reference's ``zero_1=True``
  step, and bit-equal to the port's replicated step on the same mesh
  (its reduce-scatter and the replicated all-reduce add the same two
  terms; the update is elementwise). (dp=2, pp=2) is
  ``tests/test_torch_pipeline.py``'s, dp2×tp2×sp2
  ``tests/test_torch_parallel.py``'s. Under onebit + EF on dp2×tp2 the
  tp-replicated leaves stay bit-identical on every rank.
* the refusals: ZeRO-1 on a ``slice_`` mesh or one without a dp axis
  (the reference's messages), ``zero=True`` with ``dcn_axis``, and the
  ring tier over a slice subgroup.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from pp_moe_parity import (SGD_LR, assert_onebit_held,  # noqa: E402
                           batch, fake_mesh, jnp_tree, leaf_names,
                           leg_ranks, port_groups, ref_train, tree_leaves)
from train_parity import (ONEBIT_EF, ONEBIT_LOSS_TOL, TOL,  # noqa: E402
                          ref_mesh_eval, ref_mesh_run)

from byteps_tpu.compression import from_params as j_from_params  # noqa: E402,E501
from byteps_tpu.compression.topk import resolve_k  # noqa: E402
from byteps_tpu.jax.optimizer import DistributedOptimizer as JDistOpt  # noqa: E402,E501
from byteps_tpu.jax.optimizer import dp_state_specs  # noqa: E402
from byteps_tpu.models import GPTConfig as JConfig  # noqa: E402
from byteps_tpu.models.gpt import gpt_init as j_init  # noqa: E402
from byteps_tpu.models.moe_gpt import MoEGPTConfig as JMoEConfig  # noqa: E402
from byteps_tpu.models.moe_gpt import moe_gpt_init as j_moe_init  # noqa: E402
from byteps_tpu.models.train import make_gpt_moe_train_step as j_moe_step  # noqa: E402,E501
from byteps_tpu.models.train import make_gpt_pp_train_step as j_pp_step  # noqa: E402,E501
from byteps_tpu_torch.compression import fold_in  # noqa: E402
from byteps_tpu_torch.compression import from_params as t_from_params  # noqa: E402,E501
from byteps_tpu_torch.models import GPTConfig, make_gpt_train_step  # noqa: E402,E501
from byteps_tpu_torch.parallel.mesh import (Axis, MeshAxes,  # noqa: E402
                                            collectives, rank_coords)

torch.set_num_threads(1)
SLICE_DP = {"slice_": 2, "dp": 2}
SGD = {"opt": "sgd", "lr": SGD_LR}
# ROADMAP C.1's reproduction: d 32, 2 layers, vocab 64, a (4, 16) batch,
# one step of AdamW at 1e-3
C1_CFG = {"vocab_size": 64, "max_seq": 16, "d_model": 32, "n_heads": 4,
          "n_layers": 2, "d_ff": 64}
HIER_STEPS = 3
HIER_L, HIER_RAW_L, HIER_PB = 1001, 13, 256
HIER_ONEBIT_RTOL = 1e-6          # onebit's scales, summed in another order
HIER_RAW_TOL = 1e-6              # a four-term sum, gloo's order vs XLA's
HIER = {"hier_raw": None,
        "hier_onebit": {"compressor": "onebit", "ef": "vanilla"},
        "hier_topk": {"compressor": "topk", "k": 4, "ef": "vanilla"},
        "hier_randomk": {"compressor": "randomk", "k": 0.25,
                         "ef": "vanilla"}}
LEGS = {
    4: [*({"name": nm, "kind": "hier_opt", "mesh": SLICE_DP, "comp": c,
           "steps": HIER_STEPS,
           "L": HIER_RAW_L if c is None else HIER_L,
           "pb": None if c is None else HIER_PB,
           "draws": nm == "hier_randomk"} for nm, c in HIER.items()),
        {"name": "s2dp2_raw", "kind": "train", "mesh": SLICE_DP,
         "tree": "tiny"},
        {"name": "dp4_raw", "kind": "train", "mesh": {"dp": 4},
         "tree": "tiny"},
        {"name": "s2dp2_onebit_ef", "kind": "train", "mesh": SLICE_DP,
         "tree": "tiny", "kw": {"compression_params": ONEBIT_EF}},
        {"name": "s2tp2_raw", "kind": "train",
         "mesh": {"slice_": 2, "tp": 2}, "tree": "tiny"},
        {"name": "s2pp2", "kind": "pp_train", "mesh": {"slice_": 2, "pp": 2},
         "tree": "tiny", "kw": {"n_micro": 2}, **SGD},
        {"name": "s2ep2", "kind": "moe_train",
         "mesh": {"slice_": 2, "ep": 2}, "tree": "moe", **SGD},
        {"name": "s2dp2_eval", "kind": "eval", "mesh": SLICE_DP,
         "tree": "tiny"},
        {"name": "dp2tp2_zero1", "kind": "train", "mesh": {"dp": 2, "tp": 2},
         "tree": "tiny", "kw": {"zero_1": True}},
        {"name": "dp2tp2_rep", "kind": "train", "mesh": {"dp": 2, "tp": 2},
         "tree": "tiny"},
        {"name": "dp2tp2_zero1_onebit", "kind": "train",
         "mesh": {"dp": 2, "tp": 2}, "tree": "tiny",
         "kw": {"zero_1": True, "compression_params": ONEBIT_EF}},
        {"name": "dp2ep2_zero1", "kind": "moe_train",
         "mesh": {"dp": 2, "ep": 2}, "tree": "moe",
         "kw": {"zero_1": True}, **SGD},
        {"name": "dp2ep2_rep", "kind": "moe_train", "mesh": {"dp": 2, "ep": 2},
         "tree": "moe", **SGD}],
    2: [{"name": "s2_raw", "kind": "train", "mesh": {"slice_": 2},
         "tree": "tiny"},
        {"name": "c1", "kind": "train", "mesh": {"slice_": 2}, "tree": "c1",
         "cfg": C1_CFG, "batch": "c1_", "steps": 1}],
}
ZERO1 = {"dp2tp2_zero1": "dp2tp2_rep", "dp2ep2_zero1": "dp2ep2_rep"}


def _leg(name):
    return next(g for legs in LEGS.values() for g in legs
                if g["name"] == name)


def _jcfg(leg):
    base = JMoEConfig if leg["kind"] == "moe_train" else JConfig
    return base(**{**base.tiny().__dict__, **leg.get("cfg", {})})


def _hier_rows(L):
    rng = np.random.default_rng(L)
    return rng.standard_normal((HIER_STEPS, 4, L)).astype(np.float32)


def _hier_draws():
    """The reference's randomk indices for every key the hierarchical
    step derives (step s, chunk c, segment j of the slice exchange), under
    the port's integer key of the same derivation: {port key: indices}."""
    comp = HIER["hier_randomk"]
    jseed, tseed = j_from_params(dict(comp)).seed, t_from_params(
        dict(comp)).seed
    seg = -(-HIER_L // 2)
    chunk = HIER_PB // 4
    keys, idx = [], []
    for s in range(HIER_STEPS):
        jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0),
                                                   jseed), s)
        tk = fold_in(fold_in(0, tseed), s)
        for c, off in enumerate(range(0, seg, chunk)):
            ln = min(chunk, seg - off)
            n = -(-ln // 2)
            for j in range(2):
                jkey = jax.random.fold_in(jax.random.fold_in(jk, c), j)
                k = resolve_k(comp["k"], n)
                keys.append(fold_in(fold_in(tk, c), j))
                idx.append(np.asarray(jax.random.choice(
                    jkey, n, shape=(k,), replace=False)).astype(np.int32))
    return keys, idx


@pytest.fixture(scope="module")
def data():
    trees = {"tiny": j_init(jax.random.PRNGKey(0), JConfig.tiny()),
             "c1": j_init(jax.random.PRNGKey(0),
                          JConfig(**{**JConfig.tiny().__dict__, **C1_CFG})),
             "moe": j_moe_init(jax.random.PRNGKey(0), JMoEConfig.tiny())}
    trees = {k: jax.tree.map(np.asarray, t) for k, t in trees.items()}
    tok, tgt = batch()
    rng = np.random.default_rng(21)
    c1 = rng.integers(0, C1_CFG["vocab_size"], (4, 17)).astype(np.int32)
    ev = rng.integers(0, 256, (2, 8, 33)).astype(np.int32)
    arrays = {"tok": tok, "tgt": tgt, "c1_tok": c1[:, :-1],
              "c1_tgt": c1[:, 1:], "etok": ev[:, :, :-1],
              "etgt": ev[:, :, 1:]}
    for t, tree in trees.items():
        arrays.update({f"{t}_p{i}": a
                       for i, a in enumerate(tree_leaves(tree))})
    for L in (HIER_L, HIER_RAW_L):
        arrays[f"hier_rows_{L}"] = _hier_rows(L)
    keys, idx = _hier_draws()
    arrays["draw_keys"] = np.array(keys, np.uint64)
    arrays.update({f"draw_{i}": a for i, a in enumerate(idx)})
    return trees, tok, tgt, arrays


@pytest.fixture(scope="module")
def port(data, tmp_path_factory):
    return port_groups("torch_multislice", LEGS, data[3], tmp_path_factory,
                       script="multislice_rank.py")


def _ranks(port, leg):
    return leg_ranks(port, LEGS, leg)


def _counts(o, leg) -> dict:
    return dict(zip(collectives, o[f"{leg}_collectives"].tolist()))


# --------------------------------------------------------------------------
# the hierarchical optimizer alone
# --------------------------------------------------------------------------
def _ref_hier(name):
    """The reference's ``DistributedOptimizer(dcn_axis="slice_")`` on a
    (slice_=2, dp=2) mesh, sgd(1.0) from zero: (the parameter after each
    step, each device's EF block after each step or None)."""
    leg = _leg(name)
    L, comp = leg["L"], leg["comp"]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("slice_", "dp"))
    tx = JDistOpt(optax.sgd(1.0), compression_params=comp, axis="dp",
                  num_devices=2, partition_bytes=leg["pb"],
                  dcn_axis="slice_", num_dcn=2)
    params = {"w": jnp.zeros((L,))}
    state = tx.init(params)
    sspec = dp_state_specs("dp", dcn_axis="slice_")

    def step(params, state, g):
        upd, state = tx.update({"w": g.reshape(L)}, state, params)
        return jax.tree.map(lambda p, u: p + u, params, upd), state

    sm = jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=(P(), sspec, P(("slice_", "dp"))),
        out_specs=(P(), sspec), check_vma=False))
    rows = _hier_rows(L)
    ws, efs = [], []
    for s in range(HIER_STEPS):
        params, state = sm(params, state, jnp.asarray(rows[s]))
        ws.append(np.asarray(params["w"]))
        if state.ef is not None:
            efs.append(np.asarray(state.ef).reshape(4, -1))
    return np.stack(ws), (np.stack(efs, 1) if efs else None)


@pytest.mark.parametrize("name", list(HIER))
def test_hierarchical_optimizer_matches_reference(port, name):
    w, ef = _ref_hier(name)
    outs = _ranks(port, name)
    comp = HIER[name]
    for r, o in enumerate(outs):
        got = o[f"{name}_w"]
        if comp is None:
            np.testing.assert_allclose(got, w, rtol=0, atol=HIER_RAW_TOL)
            assert f"{name}_ef" not in o
            continue
        # EF is this rank's dp segment: ceil(1001 / 2) f32, compared with
        # the reference device's block s·n_dp + d (row-major, rank r)
        assert o[f"{name}_ef"].shape == (HIER_STEPS, -(-HIER_L // 2))
        if comp["compressor"] == "onebit":
            np.testing.assert_allclose(got, w, rtol=HIER_ONEBIT_RTOL,
                                       atol=HIER_ONEBIT_RTOL)
            np.testing.assert_allclose(o[f"{name}_ef"], ef[r],
                                       rtol=HIER_ONEBIT_RTOL,
                                       atol=HIER_ONEBIT_RTOL)
        else:
            np.testing.assert_array_equal(got, w)
            np.testing.assert_array_equal(o[f"{name}_ef"], ef[r])
        # one raw dp reduce-scatter and one dp all-gather a step
        c = _counts(o, name)
        assert c["hier_dp_reduce_scatter"] == HIER_STEPS
        assert c["hier_dp_all_gather"] == HIER_STEPS
    for o in outs[1:]:
        np.testing.assert_array_equal(o[f"{name}_w"], outs[0][f"{name}_w"])


# --------------------------------------------------------------------------
# the train and eval steps on slice_ meshes
# --------------------------------------------------------------------------
def _ref_run(data, name):
    """The reference's losses and, per device, the whole parameters."""
    leg = _leg(name)
    trees, tok, tgt, arrays = data
    kw = dict(leg.get("kw", {}))
    tree = trees[leg["tree"]]
    if leg["kind"] == "train":
        pre = leg.get("batch", "")
        losses, flat = ref_mesh_run(
            tree, arrays[f"{pre}tok"], arrays[f"{pre}tgt"], leg["mesh"],
            cfg=_jcfg(leg), steps=leg.get("steps", 3), **kw)
        n = int(np.prod(list(leg["mesh"].values())))
        return losses, [flat] * n
    if leg["kind"] == "pp_train":
        kw.setdefault("compression_params", {})
        return ref_train(j_pp_step, _jcfg(leg), leg["mesh"], tok, tgt,
                         stacked=True, opt=leg.get("opt", "adamw"),
                         init_params=jnp_tree(tree), **kw)
    return ref_train(j_moe_step, _jcfg(leg), leg["mesh"], tok, tgt,
                     opt=leg.get("opt", "adamw"), **kw)


TRAIN = ["s2dp2_raw", "s2_raw", "s2tp2_raw", "s2pp2", "s2ep2", "c1"]


@pytest.mark.parametrize("name", TRAIN)
def test_slice_train_steps_match_reference(port, data, name):
    losses, views = _ref_run(data, name)
    for r, o in enumerate(_ranks(port, name)):
        np.testing.assert_allclose(o[f"{name}_loss"], losses, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(o[f"{name}_params"], views[r], rtol=TOL,
                                   atol=TOL)


def test_slice_onebit_ef_train_step_matches_reference(port, data):
    """Onebit + EF on (slice_=2, dp=2) takes the hierarchical path: PR
    19's onebit bounds against the reference's, EF one dp segment a rank,
    one raw dp reduce-scatter and all-gather a step."""
    name = "s2dp2_onebit_ef"
    losses, views = _ref_run(data, name)
    names = leaf_names(data[0]["tiny"])
    outs = _ranks(port, name)
    total = views[0].size
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o[f"{name}_loss"], losses,
                                   rtol=ONEBIT_LOSS_TOL,
                                   atol=ONEBIT_LOSS_TOL)
        assert_onebit_held(o[f"{name}_params"], views[r], names)
        assert int(o[f"{name}_ef_len"]) == -(-total // 2)
        c = _counts(o, name)
        assert c["hier_dp_reduce_scatter"] == c["hier_dp_all_gather"] == 3
        # every rank applies the one gathered aggregate
        np.testing.assert_array_equal(o[f"{name}_local"],
                                      outs[0][f"{name}_local"])


def test_slice_eval_step_matches_reference(port, data):
    trees, tok, tgt, arrays = data
    loss, ppl = ref_mesh_eval(trees["tiny"], tok, tgt, arrays["etok"],
                              arrays["etgt"], SLICE_DP)
    for o in _ranks(port, "s2dp2_eval"):
        np.testing.assert_allclose(o["s2dp2_eval_loss"], [loss], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(o["s2dp2_eval_ppl"], [ppl], rtol=TOL,
                                   atol=TOL)


def test_slice_raw_step_bit_equal_to_flat_dp(port):
    """(slice_=2, dp=2) raw sums the four workers' gradients in one
    all-reduce over the whole job, as dp=4 does: the same bits."""
    a, b = _ranks(port, "s2dp2_raw"), _ranks(port, "dp4_raw")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["s2dp2_raw_loss"], y["dp4_raw_loss"])
        np.testing.assert_array_equal(x["s2dp2_raw_local"],
                                      y["dp4_raw_local"])
        assert not any(_counts(x, "s2dp2_raw").values())


@pytest.mark.parametrize("name,groups", [
    ("c1", [[0, 1]]), ("s2_raw", [[0, 1]]), ("s2dp2_raw", [[0, 1, 2, 3]]),
    # the tp shards: ranks of one tp index hold the same leaves
    ("s2tp2_raw", [[0, 2], [1, 3]]), ("s2pp2", [[0, 2], [1, 3]]),
    ("s2ep2", [[0, 2], [1, 3]])])
def test_slices_end_each_step_bit_identical(port, name, groups):
    """ROADMAP C.1: on a live slice_ axis the gradients are summed over
    it, so the ranks that hold the same leaves on different slices end
    every step with the same bits."""
    outs = _ranks(port, name)
    for g in groups:
        for r in g[1:]:
            np.testing.assert_array_equal(outs[r][f"{name}_local"],
                                          outs[g[0]][f"{name}_local"])
            np.testing.assert_array_equal(outs[r][f"{name}_loss"],
                                          outs[g[0]][f"{name}_loss"])
    # the layout those groups assume: rank r's slice index is r // 2
    for r in range(len(outs)):
        mesh = _leg(name)["mesh"]
        assert rank_coords(MeshAxes(**mesh), r)["slice_"] == r // (
            len(outs) // 2)


# --------------------------------------------------------------------------
# ZeRO-1 over a dp subgroup
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(ZERO1))
def test_zero1_over_dp_subgroup_matches_reference(port, data, name):
    losses, views = _ref_run(data, name)
    rep = ZERO1[name]
    for r, o in enumerate(_ranks(port, name)):
        np.testing.assert_allclose(o[f"{name}_loss"], losses, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(o[f"{name}_params"], views[r], rtol=TOL,
                                   atol=TOL)
    # bit-equal to the replicated step on the same mesh: the scatter and
    # the all-reduce add the same two dp terms, the update is elementwise
    for o, q in zip(_ranks(port, name), _ranks(port, rep)):
        np.testing.assert_array_equal(o[f"{name}_loss"], q[f"{rep}_loss"])
        np.testing.assert_array_equal(o[f"{name}_local"], q[f"{rep}_local"])


def test_zero1_onebit_keeps_tp_replicas_identical(port):
    """ZeRO-1 with onebit + EF on dp2×tp2: a chunk's scale spans a rank's
    tp shards and the replicated leaves, so the port makes the replicated
    leaves' elements of each aggregated segment tp index 0's (one
    broadcast over tp) before the segment steps: every rank ends each
    step with the same bits in every leaf no tp axis splits."""
    outs = _ranks(port, "dp2tp2_zero1_onebit")
    for o in outs[1:]:
        np.testing.assert_array_equal(o["dp2tp2_zero1_onebit_rep"],
                                      outs[0]["dp2tp2_zero1_onebit_rep"])
        np.testing.assert_array_equal(o["dp2tp2_zero1_onebit_loss"],
                                      outs[0]["dp2tp2_zero1_onebit_loss"])
    c = _counts(outs[0], "dp2tp2_zero1_onebit")
    assert c["tp_broadcast"] == 3
    assert np.isfinite(outs[0]["dp2tp2_zero1_onebit_loss"]).all()


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------
def test_multislice_refusals(monkeypatch):
    """ZeRO-1 on a slice_ mesh and on a mesh without a dp axis (the
    reference's messages), ``zero=True`` with ``dcn_axis`` (the
    reference's), ``dcn_axis`` without the joined axis, and the ring tier
    over a slice subgroup (ROADMAP A.6)."""
    from byteps_tpu_torch import optimizer as topt
    from byteps_tpu_torch.common.config import reset_config

    cfg = GPTConfig.tiny()
    with pytest.raises(ValueError, match="zero_3=True for multi-slice"):
        make_gpt_train_step(cfg, device="cpu", zero_1=True,
                            mesh=fake_mesh(SLICE_DP, 0))
    with pytest.raises(ValueError, match="requires a dp mesh axis"):
        make_gpt_train_step(cfg, device="cpu", zero_1=True,
                            mesh=fake_mesh({"tp": 2}, 0))
    p = torch.zeros(8, requires_grad=True)
    slc = Axis("slice_", 2, 0, (0, 2), group=object())
    dp = Axis("dp", 2, 0, (0, 1), group=object())
    joint = Axis("slice_+dp", 4, 0, (0, 1, 2, 3), group=object())
    with pytest.raises(ValueError, match="mutually exclusive"):
        topt.DistributedOptimizer(torch.optim.SGD([p], lr=0.1), [p],
                                  zero=True, axis=dp, dcn_axis=slc,
                                  joint_axis=joint)
    with pytest.raises(ValueError, match="joint_axis"):
        topt.DistributedOptimizer(torch.optim.SGD([p], lr=0.1), [p],
                                  axis=dp, dcn_axis=slc)
    monkeypatch.setattr(topt, "world", lambda group=None: (4, 0))
    monkeypatch.setattr(topt, "reduce_scatter_body",
                        lambda x, n, group=None: x[:-(-x.shape[0] // n)])
    opt = topt.DistributedOptimizer(
        torch.optim.SGD([p], lr=0.1), [p], ONEBIT_EF, axis=dp,
        dcn_axis=slc, joint_axis=joint)
    p.grad = torch.ones(8)
    monkeypatch.setenv("BYTEPS_ICI_TIER", "ring")
    reset_config()
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP A.6"):
            opt.step()
    finally:
        monkeypatch.delenv("BYTEPS_ICI_TIER")
        reset_config()
