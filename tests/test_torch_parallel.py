"""The port's tensor and sequence parallelism against the reference's, on
``GPTConfig.tiny()`` and a tiny llama (RoPE, GQA with kv heads divisible
by tp, SwiGLU, RMSNorm, untied readout) in f32, from the reference's own
weights.

The reference runs its ``make_gpt_train_step``/``make_eval_step`` on a
mesh of the conftest's CPU devices; the port runs the same mesh as gloo
rank processes (``tests/helpers/train_rank.py``'s mesh legs: every rank
takes the global batch of 4 × 32 and keeps its block), three steps of
AdamW (``optax.adamw(1e-3)`` and the port's ``adamw``):

* the mesh layout (rank r where the reference's device r sits),
  ``factor_devices``, the partitioner's specs and this rank's block of
  a batch and of each leaf equal the reference's;
* dp2×tp2×sp2 raw, with ``accum_steps=2`` and with the dense readout
  (``chunked_ce=False``): losses and the gathered parameters within 1e-5
  of the reference's; remat on and off equal bit for bit; AdamW's first
  moments gathered over tp equal a one-rank run's within 1e-5;
* dp2×tp2×sp2 ZeRO-1 over each (tp, sp) rank's dp line: within 1e-5 of
  the reference's ``zero_1=True`` step and bit-equal to the raw leg;
* dp2×tp2×sp2 onebit + EF: losses within 1e-4 of the reference's and
  the parameters further than 1e-5 from its below a share of 1e-3 (the
  onebit training bounds). A chunk's onebit scale spans a rank's tp
  shards and the replicated leaves, so the reference's tp replicas of
  the replicated leaves drift apart (by about lr) and its next forward
  mixes them; the port keeps tp index 0's aggregate on every tp rank,
  and the reference is held to that by setting every replica to device
  0's after each of its steps;
* the tp-replicated leaves are bit-identical on every rank of every leg;
* the zigzag layout on dp2×sp2 within 1e-5 of the reference's zigzag
  step and within the reference's own 2e-4 of its dense dp2 step;
* the llama options on tp2×sp2; ``chunked_ce="vocab_parallel"`` on
  dp2×tp2 and tp2×sp2; eval and perplexity on dp2×tp2;
* the vocab-parallel CE at tp = 4 (V = 96) against the reference's
  dense golden, values and gradients at its own 1e-5/1e-6, and V = 66,
  which does not divide, computed whole on every rank (no collective).

Each group of rank processes runs once a test session (the first xdist
worker to need it runs it under a file lock and leaves its outputs for
the others).
"""

import contextlib
import fcntl
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from train_parity import (MESH_ROWS, ONEBIT_EF,  # noqa: E402
                          ONEBIT_LOSS_TOL, ONEBIT_OFF_SHARE, TOL, JConfig,
                          inputs, j_mesh, llama_cfg, llama_tree,
                          mesh_arrays, off_share, port_mesh_run,
                          ref_mesh_eval, ref_mesh_run)
import train_rank  # noqa: E402

from byteps_tpu.models.gpt import block_specs as j_block_specs  # noqa: E402
from byteps_tpu.models.gpt import gpt_param_specs as j_gpt_specs  # noqa: E402,E501
from byteps_tpu.ops.chunked_ce import dense_ce_nll  # noqa: E402
from byteps_tpu.parallel import Partitioner as JPartitioner  # noqa: E402
from byteps_tpu.parallel import factor_devices as j_factor  # noqa: E402
from byteps_tpu.parallel import zigzag_permutation as j_zperm  # noqa: E402
from byteps_tpu_torch.models import GPTConfig, params_from_numpy  # noqa: E402,E501
from byteps_tpu_torch.models.convert import flat_leaves  # noqa: E402
from byteps_tpu_torch.models.gpt import block_specs, gpt_param_specs  # noqa: E402,E501
from byteps_tpu_torch.parallel.mesh import (Axis, Mesh, MeshAxes,  # noqa: E402
                                            factor_devices, layout,
                                            rank_coords)
from byteps_tpu_torch.parallel.partitioner import Partitioner  # noqa: E402

torch.set_num_threads(1)
AXES8 = {"dp": 2, "tp": 2, "sp": 2}
CE_RTOL, CE_ATOL = 1e-5, 1e-6          # the reference's chunked-CE bounds
ZIGZAG_DENSE_TOL = 2e-4                # the reference's zigzag-vs-dense
ZIGZAG_STEPS = 5
LEGS = {
    8: [{"name": "raw", "mesh": AXES8, "moments": True},
        {"name": "remat", "mesh": AXES8, "kw": {"remat": True}},
        {"name": "onebit_ef", "mesh": AXES8,
         "kw": {"compression_params": ONEBIT_EF}},
        {"name": "accum", "mesh": AXES8, "kw": {"accum_steps": 2}},
        {"name": "dense_ce", "mesh": AXES8, "kw": {"chunked_ce": False}},
        {"name": "zero1", "mesh": AXES8, "kw": {"zero_1": True}}],
    4: [{"name": "zigzag", "mesh": {"dp": 2, "sp": 2}, "zigzag": True,
         "steps": ZIGZAG_STEPS, "kw": {"seq_layout": "zigzag"}},
        {"name": "llama", "mesh": {"tp": 2, "sp": 2}, "tree": "llama",
         "cfg": llama_cfg()},
        {"name": "vocab_dp_tp", "mesh": {"dp": 2, "tp": 2},
         "kw": {"chunked_ce": "vocab_parallel"}},
        {"name": "vocab_tp_sp", "mesh": {"tp": 2, "sp": 2},
         "kw": {"chunked_ce": "vocab_parallel"}},
        {"name": "eval", "mesh": {"dp": 2, "tp": 2}, "kind": "eval"},
        {"name": "ce", "mesh": {"tp": 4}, "kind": "ce",
         "vocabs": [96, 66]}],
    1: [{"name": "raw_one", "mesh": {}, "moments": True}],
}
# the legs' reference runs: (mesh axes, cfg, options)
REF = {"raw": (AXES8, {}), "accum": (AXES8, {"accum_steps": 2}),
       "zero1": (AXES8, {"zero_1": True}),
       "dense_ce": (AXES8, {"chunked_ce": False}),
       "onebit_ef": (AXES8,
                                         {"compression_params": ONEBIT_EF}),
       "llama": ({"tp": 2, "sp": 2}, {}),
       "vocab_dp_tp": ({"dp": 2, "tp": 2}, {"chunked_ce": "vocab_parallel"}),
       "vocab_tp_sp": ({"tp": 2, "sp": 2}, {"chunked_ce": "vocab_parallel"})}


def _ce_arrays() -> dict:
    rng = np.random.default_rng(3)
    d = 24
    out = {"ce_h": rng.standard_normal((3, 17, d)).astype(np.float32)}
    for V in (96, 66):
        out[f"ce_head{V}"] = rng.standard_normal((d, V)).astype(np.float32)
        out[f"ce_tgt{V}"] = rng.integers(0, V, (3, 17)).astype(np.int64)
    return out


@contextlib.contextmanager
def _locked(path: Path):
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


@pytest.fixture(scope="module")
def data():
    return inputs(), llama_tree()


@pytest.fixture(scope="module")
def port(data, tmp_path_factory):
    """{n: [each rank's outputs]} of the legs at n ranks, computed once a
    session across xdist workers."""
    base = tmp_path_factory.getbasetemp()
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    res = {}
    for n, legs in LEGS.items():
        done = shared / f"torch_parallel_{n}"
        with _locked(shared / f"torch_parallel_{n}.lock"):
            if not (done / "ok").exists():
                done.mkdir(exist_ok=True)
                arrays = {**mesh_arrays(data[0], data[1]), **_ce_arrays()}
                if n == 1:
                    np.savez(done / "in.npz", **arrays)
                    (done / "legs.json").write_text(json.dumps(legs))
                    outs = [train_rank.run_legs(str(done), 0, 1)]
                else:
                    outs = port_mesh_run(done, n, legs, arrays)
                for r, o in enumerate(outs):
                    np.savez(done / f"res{r}.npz", **o)
                (done / "ok").write_text("")
        res[n] = [dict(np.load(done / f"res{r}.npz")) for r in range(n)]
    return res


def _ranks(port, leg):
    n = next(k for k, legs in LEGS.items() if any(g["name"] == leg
                                                  for g in legs))
    return port[n]


def _ref(data, leg, steps=3):
    axes, kw = REF[leg]
    if leg == "onebit_ef":
        kw = {**kw, "resync": True}
    tree = data[1] if leg == "llama" else data[0][0]
    cfg = JConfig.llama(**llama_cfg()) if leg == "llama" else JConfig.tiny()
    tok, tgt = data[0][1][:MESH_ROWS], data[0][2][:MESH_ROWS]
    return ref_mesh_run(tree, tok, tgt, axes, cfg=cfg, steps=steps, **kw)


# --------------------------------------------------------------------------
# mesh, factoring, partitioner, blocks
# --------------------------------------------------------------------------
MESHES = [{"dp": 2, "tp": 2, "sp": 2}, {"dp": 2, "tp": 2}, {"sp": 4},
          {"tp": 2, "sp": 2}, {"dp": 8}, {"dp": 2, "sp": 2}, {}]
MESH_IDS = ["dp2tp2sp2", "dp2tp2", "sp4", "tp2sp2", "dp8", "dp2sp2", "one"]


def _fake_mesh(axes: dict, rank: int) -> Mesh:
    """This rank's Mesh of ``axes`` without process groups (specs and
    blocks need none)."""
    ma = MeshAxes(**axes)
    names, sizes = layout(ma)
    coords = rank_coords(ma, rank)
    return Mesh({nm: Axis(nm, s, coords[nm], ()) for nm, s in
                 zip(names, sizes)}, rank)


@pytest.mark.parametrize("n", range(1, 9))
def test_factor_devices_matches_reference(n):
    for kw in ({}, {"want_tp": 4}, {"want_sp": 4, "want_tp": 1}):
        assert dataclass_dict(factor_devices(n, **kw)) == \
            dataclass_dict(j_factor(n, **kw))


def dataclass_dict(a) -> dict:
    return {k: getattr(a, k) for k in ("dp", "tp", "sp", "pp", "ep",
                                       "slice_")}


@pytest.mark.parametrize("axes", MESHES, ids=MESH_IDS)
def test_mesh_layout_matches_reference(axes):
    """Rank r sits where the reference's device r sits."""
    jm = j_mesh(axes) if axes else None
    ma = MeshAxes(**axes)
    names, sizes = layout(ma)
    if jm is None:
        assert sizes == (1,) * 6
        assert names == ("slice_", "pp", "dp", "sp", "tp", "ep")
        return
    assert tuple(jm.axis_names) == names
    assert tuple(jm.shape[a] for a in names) == sizes
    for idx, dev in np.ndenumerate(jm.devices):
        assert rank_coords(ma, dev.id) == dict(zip(names, idx))


@pytest.mark.parametrize("axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("cfg", ["tiny", "llama", "untied_rms"])
def test_partitioner_specs_match_reference(axes, cfg):
    if cfg == "tiny":
        tcfg, jcfg = GPTConfig.tiny(), JConfig.tiny()
    elif cfg == "llama":
        tcfg, jcfg = (GPTConfig.llama(**llama_cfg()),
                      JConfig.llama(**llama_cfg()))
    else:
        kw = dict(tied_readout=False, norm="rmsnorm", mlp="swiglu")
        tcfg = GPTConfig(**{**GPTConfig.tiny().__dict__, **kw})
        jcfg = JConfig(**{**JConfig.tiny().__dict__, **kw})
    jp = JPartitioner.for_config(jcfg, j_mesh(axes) if axes
                                 else j_mesh({"dp": 1}))
    tp_ = Partitioner.for_config(tcfg, _fake_mesh(axes, 0))
    as_tuples = jax.tree.map(tuple, jp.param_specs(jcfg),
                             is_leaf=lambda x: isinstance(
                                 x, jax.sharding.PartitionSpec))
    assert tp_.param_specs(tcfg) == as_tuples
    assert tp_.batch_spec() == tuple(jp.batch_spec())
    for a in ("dp", "tp", "sp", "pp", "ep", "slice_"):
        assert getattr(tp_, a) == getattr(jp, a)
        assert tp_.axis_size(a) == jp.axis_size(a)
    for logical in ("batch", "seq", "embed", "mlp", "heads", "kv", "vocab"):
        assert tp_.mesh_axes(logical) == jp.mesh_axes(logical)


@pytest.mark.parametrize("tp_axis", [None, "tp"])
@pytest.mark.parametrize("mlp,use_bias,norm", [
    ("gelu", True, "layernorm"), ("swiglu", False, "rmsnorm")])
def test_spec_wrappers_match_reference(tp_axis, mlp, use_bias, norm):
    def tup(tree):
        return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    assert block_specs(tp_axis, mlp, use_bias, norm) == \
        tup(j_block_specs(tp_axis, mlp, use_bias, norm))
    cfg = GPTConfig(**{**GPTConfig.tiny().__dict__, "mlp": mlp,
                       "use_bias": use_bias, "norm": norm})
    jcfg = JConfig(**{**JConfig.tiny().__dict__, "mlp": mlp,
                      "use_bias": use_bias, "norm": norm})
    assert gpt_param_specs(cfg, tp_axis) == tup(j_gpt_specs(jcfg, tp_axis))


@pytest.mark.parametrize("axes", MESHES[:-1], ids=MESH_IDS[:-1])
def test_blocks_match_reference_shards(data, axes):
    """Each rank's block of the global batch (``local_batch``) and of
    each leaf (``params_from_numpy(mesh=)``) is the reference's shard on
    the device of the same index."""
    tree, tok = data[0][0], data[0][1]
    jm = j_mesh(axes)
    cfg, jcfg = GPTConfig.tiny(), JConfig.tiny()
    jp = JPartitioner.for_config(jcfg, jm)
    rows = 8 if axes.get("dp", 1) == 8 else MESH_ROWS
    batch = jax.device_put(tok[:rows], jp.batch_sharding())
    pshard = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            jp.param_sharding(jcfg))
    want_p = {}
    for leaf_i, leaf in enumerate(jax.tree.leaves(pshard)):
        for s in leaf.addressable_shards:
            want_p[(leaf_i, s.device.id)] = np.asarray(s.data)
    for s in batch.addressable_shards:
        r = s.device.id
        part = Partitioner.for_config(cfg, _fake_mesh(axes, r))
        np.testing.assert_array_equal(part.local_batch(tok[:rows]),
                                      np.asarray(s.data))
        mine = flat_leaves(params_from_numpy(tree, cfg, device="cpu",
                                             mesh=_fake_mesh(axes, r)))
        for leaf_i, t in enumerate(mine):
            np.testing.assert_array_equal(t.numpy(), want_p[(leaf_i, r)])


# --------------------------------------------------------------------------
# the training and eval steps on meshes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("leg", ["raw", "accum", "dense_ce", "llama",
                                 "vocab_dp_tp", "vocab_tp_sp"])
def test_mesh_step_matches_reference(port, data, leg):
    losses, params = _ref(data, leg)
    for o in _ranks(port, leg):
        np.testing.assert_allclose(o[f"{leg}_loss"], losses, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(o[f"{leg}_params"], params, rtol=TOL,
                                   atol=TOL)


def test_onebit_ef_mesh_step_matches_reference(port, data):
    losses, params = _ref(data, "onebit_ef")
    for o in _ranks(port, "onebit_ef"):
        np.testing.assert_allclose(o["onebit_ef_loss"], losses,
                                   rtol=ONEBIT_LOSS_TOL,
                                   atol=ONEBIT_LOSS_TOL)
        assert off_share(o["onebit_ef_params"], params) < ONEBIT_OFF_SHARE


def test_remat_on_a_mesh_is_bit_equal(port):
    for o in _ranks(port, "raw"):
        np.testing.assert_array_equal(o["remat_loss"], o["raw_loss"])
        np.testing.assert_array_equal(o["remat_params"], o["raw_params"])


@pytest.mark.parametrize("leg", ["raw", "remat", "onebit_ef", "accum",
                                 "dense_ce", "zigzag", "llama",
                                 "vocab_dp_tp", "vocab_tp_sp"])
def test_replicated_leaves_bit_identical_across_ranks(port, leg):
    """Every rank holds the same bits of each tp-replicated leaf (and of
    the whole parameters, gathered), after the steps of every leg."""
    outs = _ranks(port, leg)
    for o in outs[1:]:
        np.testing.assert_array_equal(o[f"{leg}_rep"], outs[0][f"{leg}_rep"])
        np.testing.assert_array_equal(o[f"{leg}_params"],
                                      outs[0][f"{leg}_params"])
    coords = {tuple(o[f"{leg}_coords"]) for o in outs}
    assert len(coords) == len(outs)


def test_moments_gathered_over_tp_match_one_rank(port):
    one = port[1][0]["raw_one_m1"]
    for o in _ranks(port, "raw"):
        np.testing.assert_allclose(o["raw_m1"], one, rtol=TOL, atol=TOL)


def test_zigzag_step_matches_reference_and_dense(port, data):
    tree, tok, tgt = data[0][:3]
    tok, tgt = tok[:MESH_ROWS], tgt[:MESH_ROWS]
    axes = {"dp": 2, "sp": 2}
    perm = np.asarray(j_zperm(tok.shape[1], 2))
    zz, _ = ref_mesh_run(tree, tok[:, perm], tgt[:, perm], axes,
                         steps=ZIGZAG_STEPS, seq_layout="zigzag")
    dense, _ = ref_mesh_run(tree, tok, tgt, {"dp": 2}, steps=ZIGZAG_STEPS)
    for o in _ranks(port, "zigzag"):
        np.testing.assert_allclose(o["zigzag_loss"], zz, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(o["zigzag_loss"], dense,
                                   rtol=ZIGZAG_DENSE_TOL,
                                   atol=ZIGZAG_DENSE_TOL)


def test_eval_and_perplexity_match_reference(port, data):
    tree, tok, tgt, etok, etgt = data[0]
    loss, ppl = ref_mesh_eval(tree, tok[:MESH_ROWS], tgt[:MESH_ROWS],
                              etok[:, :MESH_ROWS], etgt[:, :MESH_ROWS],
                              {"dp": 2, "tp": 2})
    for o in _ranks(port, "eval"):
        np.testing.assert_allclose(o["eval_loss"], [loss], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(o["eval_ppl"], [ppl], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("V", [96, 66], ids=["split", "indivisible"])
def test_vocab_parallel_ce_matches_dense_golden(port, V):
    a = _ce_arrays()
    h, head, tgt = (jnp.asarray(a[k]) for k in ("ce_h", f"ce_head{V}",
                                                 f"ce_tgt{V}"))
    want = np.asarray(dense_ce_nll(h, head, tgt))
    dh, dhead = jax.grad(lambda x, w: dense_ce_nll(x, w, tgt).mean(),
                         argnums=(0, 1))(h, head)
    for o in _ranks(port, "ce"):
        np.testing.assert_allclose(o[f"ce_{V}_nll"], want, rtol=CE_RTOL,
                                   atol=CE_ATOL)
        np.testing.assert_allclose(o[f"ce_{V}_dh"], np.asarray(dh),
                                   rtol=CE_RTOL, atol=CE_ATOL)
        np.testing.assert_allclose(o[f"ce_{V}_dhead"], np.asarray(dhead),
                                   rtol=CE_RTOL, atol=CE_ATOL)


def test_zero1_over_dp_subgroup_matches_reference(port, data):
    """ZeRO-1 on dp2×tp2×sp2 shards each (tp, sp) rank's optimizer state
    over its dp line: within 1e-5 of the reference's ``zero_1=True``
    step, and bit-equal to the port's replicated step on the same mesh
    (the scatter and the all-reduce add the same two dp terms; AdamW is
    elementwise)."""
    losses, params = _ref(data, "zero1")
    for o in _ranks(port, "zero1"):
        np.testing.assert_allclose(o["zero1_loss"], losses, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(o["zero1_params"], params, rtol=TOL,
                                   atol=TOL)
    for o, q in zip(_ranks(port, "zero1"), _ranks(port, "raw")):
        np.testing.assert_array_equal(o["zero1_loss"], q["raw_loss"])
        np.testing.assert_array_equal(o["zero1_params"], q["raw_params"])


def test_mesh_refusals():
    """What the port refuses on a mesh, by name: zigzag without an sp
    axis (the reference's ValueError) and a mesh that is not the job's
    size. (The ring tier over a dp subgroup runs:
    ``tests/test_torch_ring_subgroup.py``.)"""
    from byteps_tpu_torch.models import make_gpt_train_step
    from byteps_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="requires a mesh with an sp axis"):
        make_gpt_train_step(GPTConfig.tiny(), device="cpu",
                            mesh=_fake_mesh({"dp": 2, "tp": 2}, 0),
                            seq_layout="zigzag")
    with pytest.raises(ValueError, match="require 2 ranks"):
        make_mesh(MeshAxes(tp=2))
    one = make_mesh(MeshAxes())           # every axis at size 1
    assert one.axis_names == ("slice_", "pp", "dp", "sp", "tp", "ep")
    assert all(one.axis_size(a) == 1 for a in one.axis_names)
