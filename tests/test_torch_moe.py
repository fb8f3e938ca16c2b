"""The port's expert parallelism against the reference's, on the CPU in
f32, from the reference's own weights.

* ``topk_dispatch`` at k = 1 and 2 with a binding capacity, both
  packages fed the same logits (random, and integer logits full of exact
  ties, where both argmaxes take the first maximum): the dispatch
  tensors exactly equal, combine and aux within 1e-6; k > E refused with
  the reference's message.
* ``moe_ffn`` with all experts on one rank, at a binding capacity and
  under ``no_drop``: output, aux and gradients within 1e-5.
* ``moe_ffn`` on ep2 and ep2×tp2, gelu and swiglu (gated) experts,
  tokens split over ep, on gloo rank processes (``tests/helpers/
  pp_moe_rank.py``): each rank's output and aux within 1e-5 of the
  reference's ``moe_ffn`` over ep on the conftest's CPU mesh, and the
  gradients of ``mean(y²) + 0.01·aux`` (the rank's own) within 1e-5 of
  the reference's dense ``moe_ffn`` on each rank's tokens: the gate's of
  the rank's own loss, the experts' (this rank's shard) and the input's
  of the sum over the ep ranks' losses, as the exchange's backward
  brings them.
* ``make_gpt_moe_train_step`` on dp2×ep2, ep2×tp2, ep2×sp2 and
  ``make_gpt_moe_pp_train_step`` on pp2×dp2×ep2 and pp2×sp2 (aux_coef
  1.0, where averaging the nll alone over sp would double the
  load-balancing gradient), 3 SGD steps (lr 0.5, as the pipeline tests)
  from ``moe_gpt_init(PRNGKey(0))``'s weights, the reference factories'
  own: losses and the gathered parameters within 1e-5 of the reference
  factory's on the same mesh (the pipelined one in its explicit gradient
  assembly, ROADMAP C). ``MoEGPTConfig.tiny()``'s capacity factor 4 does
  not bind, so the microbatches route as the reference's do.
* dp2×ep2 onebit + EF (AdamW): PR 19's onebit bounds, the key bias held
  to its sign noise.
* the collectives: two exchanges over ep a layer and microbatch each
  way, one ep gradient sum a step.
* the refusals, with the reference's messages.
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
from pp_moe_parity import (SGD_LR, assert_onebit_held,  # noqa: E402
                           batch, fake_mesh, j_mesh, leaf_names, leg_ranks,
                           port_groups, ref_train, tree_leaves)
from train_parity import ONEBIT_EF, ONEBIT_LOSS_TOL, TOL  # noqa: E402

from byteps_tpu.models.moe_gpt import MoEGPTConfig as JMoEConfig  # noqa: E402
from byteps_tpu.models.moe_gpt import moe_gpt_init as j_moe_init  # noqa: E402
from byteps_tpu.models.train import make_gpt_moe_pp_train_step as j_moe_pp  # noqa: E402,E501
from byteps_tpu.models.train import make_gpt_moe_train_step as j_moe_step  # noqa: E402,E501
from byteps_tpu.parallel.moe import moe_ffn as j_moe_ffn  # noqa: E402
from byteps_tpu.parallel.moe import moe_init as j_ffn_init  # noqa: E402
from byteps_tpu.parallel.moe import moe_specs as j_moe_specs  # noqa: E402
from byteps_tpu.parallel.moe import topk_dispatch as j_dispatch  # noqa: E402
from byteps_tpu_torch.models.convert import shard_leaf  # noqa: E402
from byteps_tpu_torch.parallel.mesh import collectives, rank_coords  # noqa: E402,E501
from byteps_tpu_torch.parallel.mesh import MeshAxes as TMeshAxes  # noqa: E402,E501
from byteps_tpu_torch.parallel.moe import (moe_ffn, moe_specs,  # noqa: E402
                                           topk_dispatch)

torch.set_num_threads(1)
DISPATCH_TOL = 1e-6
FFN_T, FFN_D, FFN_FF, FFN_E = 32, 16, 32, 8   # tokens, width, ff, experts
FFN_CAP = 8.0
SGD = {"opt": "sgd", "lr": SGD_LR}
LEGS = {
    2: [{"name": "ffn_ep2_gelu", "kind": "moe_ffn", "mesh": {"ep": 2},
         "mlp": "gelu"},
        {"name": "ffn_ep2_swiglu", "kind": "moe_ffn", "mesh": {"ep": 2},
         "mlp": "swiglu"}],
    4: [{"name": "ffn_ep2_tp2_gelu", "kind": "moe_ffn",
         "mesh": {"ep": 2, "tp": 2}, "mlp": "gelu"},
        {"name": "ffn_ep2_tp2_swiglu", "kind": "moe_ffn",
         "mesh": {"ep": 2, "tp": 2}, "mlp": "swiglu"},
        {"name": "dp2_ep2", "kind": "moe_train", "mesh": {"dp": 2, "ep": 2},
         "tree": "moe", **SGD},
        {"name": "ep2_tp2", "kind": "moe_train", "mesh": {"ep": 2, "tp": 2},
         "tree": "moe", **SGD},
        {"name": "ep2_sp2", "kind": "moe_train", "mesh": {"ep": 2, "sp": 2},
         "tree": "moe", **SGD},
        {"name": "pp2_sp2_aux1", "kind": "moe_pp_train",
         "mesh": {"pp": 2, "sp": 2}, "tree": "moe", "cfg": {"aux_coef": 1.0},
         "kw": {"n_micro": 2}, **SGD},
        {"name": "dp2_ep2_onebit_ef", "kind": "moe_train",
         "mesh": {"dp": 2, "ep": 2}, "tree": "moe",
         "kw": {"compression_params": ONEBIT_EF}}],
    8: [{"name": "pp2_dp2_ep2", "kind": "moe_pp_train",
         "mesh": {"pp": 2, "dp": 2, "ep": 2}, "tree": "moe",
         "kw": {"n_micro": 2}, **SGD}],
}
TRAIN = ["dp2_ep2", "ep2_tp2", "ep2_sp2", "pp2_sp2_aux1", "pp2_dp2_ep2"]
FFN = ["ffn_ep2_gelu", "ffn_ep2_swiglu", "ffn_ep2_tp2_gelu",
       "ffn_ep2_tp2_swiglu"]


def _leg(name):
    return next(g for legs in LEGS.values() for g in legs
                if g["name"] == name)


def _jcfg(leg):
    return JMoEConfig(**{**JMoEConfig.tiny().__dict__,
                         **leg.get("cfg", {})})


def _ffn_params(mlp):
    return jax.tree.map(np.asarray, j_ffn_init(
        jax.random.PRNGKey(0), FFN_D, FFN_FF, FFN_E, mlp=mlp))


def _ffn_x():
    return np.random.RandomState(2).randn(FFN_T, FFN_D).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    tree = jax.tree.map(np.asarray, j_moe_init(jax.random.PRNGKey(0),
                                               JMoEConfig.tiny()))
    tok, tgt = batch()
    arrays = {"tok": tok, "tgt": tgt, "ffn_x": _ffn_x()}
    arrays.update({f"moe_p{i}": a for i, a in enumerate(tree_leaves(tree))})
    for mlp in ("gelu", "swiglu"):
        arrays.update({f"ffn_{mlp}_p{i}": a for i, a in
                       enumerate(tree_leaves(_ffn_params(mlp)))})
    return tree, tok, tgt, arrays


@pytest.fixture(scope="module")
def port(data, tmp_path_factory):
    return port_groups("torch_moe", LEGS, data[3], tmp_path_factory)


def _ranks(port, leg):
    return leg_ranks(port, LEGS, leg)


# --------------------------------------------------------------------------
# topk_dispatch
# --------------------------------------------------------------------------
def _logits(kind):
    rng = np.random.RandomState(5)
    if kind == "ties":
        return rng.randint(0, 3, (48, 6)).astype(np.float32)
    return rng.randn(48, 6).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("capacity", [3, 6, 48], ids=["tight", "binding",
                                                       "free"])
def test_topk_dispatch_matches_reference(k, kind, capacity):
    lg = _logits(kind)
    want = [np.asarray(a) for a in j_dispatch(jnp.asarray(lg), capacity, k)]
    got = [t.numpy() for t in topk_dispatch(torch.from_numpy(lg), capacity,
                                            k)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=DISPATCH_TOL,
                               atol=DISPATCH_TOL)
    np.testing.assert_allclose(got[2], want[2], rtol=DISPATCH_TOL,
                               atol=DISPATCH_TOL)
    if capacity < 48 // 6:
        # the capacity binds: some (token, choice) dropped
        assert got[0].sum() < 48 * k


def test_topk_dispatch_router_gradient_matches_reference():
    lg = _logits("random")
    want = jax.grad(lambda x: (j_dispatch(x, 6, 2)[1] ** 2).sum()
                    + j_dispatch(x, 6, 2)[2])(jnp.asarray(lg))
    x = torch.from_numpy(lg).requires_grad_()
    _, comb, aux = topk_dispatch(x, 6, 2)
    ((comb ** 2).sum() + aux).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want),
                               rtol=DISPATCH_TOL, atol=DISPATCH_TOL)


def test_topk_dispatch_rejects_k_above_experts():
    with pytest.raises(ValueError, match="1 <= k <= n_experts"):
        topk_dispatch(torch.zeros(4, 3), 2, k=4)
    with pytest.raises(ValueError, match="1 <= k <= n_experts"):
        j_dispatch(jnp.zeros((4, 3)), 2, k=4)


# --------------------------------------------------------------------------
# moe_ffn
# --------------------------------------------------------------------------
def _ffn_golden(mlp, axes):
    """The reference's per-rank values over ep (its ``moe_ffn`` with
    ``ep_axis``/``tp_axis`` on the mesh) and gradients (its dense
    ``moe_ffn`` on each ep shard's tokens)."""
    params = _ffn_params(mlp)
    jp = jax.tree.map(jnp.asarray, params)
    x = jnp.asarray(_ffn_x())
    ep = axes["ep"]
    T = FFN_T // ep
    tp = "tp" if "tp" in axes else None
    mesh = j_mesh(axes)
    specs = j_moe_specs("ep", tp, mlp=mlp)

    def run(x, p):
        y, aux = j_moe_ffn(x, p, capacity_factor=FFN_CAP, ep_axis="ep",
                           tp_axis=tp)
        return y, aux[None]

    y, aux = jax.jit(jax.shard_map(
        run, mesh=mesh, in_specs=(P("ep"), specs),
        out_specs=(P("ep"), P("ep")), check_vma=False))(x, jp)

    def loss_i(p, xi):
        yi, ai = j_moe_ffn(xi, p, capacity_factor=FFN_CAP)
        return (yi ** 2).mean() + 0.01 * ai

    def total(p, x):
        return sum(loss_i(p, x[i * T:(i + 1) * T]) for i in range(ep))

    g_all, g_x = jax.grad(total, argnums=(0, 1))(jp, x)
    g_wg = [np.asarray(jax.grad(loss_i)(jp, x[i * T:(i + 1) * T])["wg"])
            for i in range(ep)]
    return (np.asarray(y), np.asarray(aux), jax.tree.map(np.asarray, g_all),
            np.asarray(g_x), g_wg, T)


@pytest.mark.parametrize("leg", FFN)
def test_moe_ffn_matches_reference(port, leg):
    g = _leg(leg)
    axes, mlp = g["mesh"], g["mlp"]
    y, aux, g_all, g_x, g_wg, T = _ffn_golden(mlp, axes)
    tspecs = moe_specs("ep", "tp" if "tp" in axes else None, mlp=mlp)
    kw = dict(rtol=TOL, atol=TOL)
    for r, o in enumerate(_ranks(port, leg)):
        i = rank_coords(TMeshAxes(**axes), r)["ep"]
        rows = slice(i * T, (i + 1) * T)
        np.testing.assert_allclose(o[f"{leg}_y"], y[rows], **kw)
        np.testing.assert_allclose(o[f"{leg}_aux"], aux[i], **kw)
        np.testing.assert_allclose(o[f"{leg}_dx"], g_x[rows], **kw)
        np.testing.assert_allclose(o[f"{leg}_dwg"], g_wg[i], **kw)
        mesh = fake_mesh(axes, r)
        for k in g_all:
            if k != "wg":
                np.testing.assert_allclose(
                    o[f"{leg}_d{k}"], shard_leaf(g_all[k], tspecs[k], mesh),
                    **kw)


@pytest.mark.parametrize("mlp", ["gelu", "swiglu"])
@pytest.mark.parametrize("cap,no_drop", [(1.0, False), (1.0, True)],
                         ids=["binding", "no_drop"])
def test_moe_ffn_one_rank_matches_reference(mlp, cap, no_drop):
    """All experts on one rank: output, aux and the gradients of
    ``mean(y²) + 0.01·aux`` within 1e-5 of the reference's, at a capacity
    that binds (some tokens dropped) and under ``no_drop`` (capacity T:
    none dropped)."""
    params = _ffn_params(mlp)
    x = _ffn_x()

    def j_loss(p, x):
        y, aux = j_moe_ffn(x, p, capacity_factor=cap, no_drop=no_drop)
        return (y ** 2).mean() + 0.01 * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_()
    ty, taux = moe_ffn(tx, tp, capacity_factor=cap, no_drop=no_drop)
    ((ty ** 2).mean() + 0.01 * taux).backward()
    kw = dict(rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), **kw)
    np.testing.assert_allclose(float(taux), float(aux), **kw)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **kw)
    for k, t in tp.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gp[k]), **kw)
    dropped = (np.abs(np.asarray(y)).sum(-1) == 0).sum()
    assert (dropped == 0) if no_drop else (dropped > 0)


# --------------------------------------------------------------------------
# the MoE train steps
# --------------------------------------------------------------------------
def _ref_moe(data, name):
    g = _leg(name)
    _, tok, tgt, _ = data
    kw = dict(g.get("kw", {}))
    pp = g["kind"] == "moe_pp_train"
    if pp:
        kw.setdefault("compression_params", {})
    return ref_train(j_moe_pp if pp else j_moe_step, _jcfg(g), g["mesh"],
                     tok, tgt, stacked=pp, opt=g.get("opt", "adamw"), **kw)


@pytest.mark.parametrize("leg", TRAIN)
def test_moe_step_matches_reference(port, data, leg):
    losses, views = _ref_moe(data, leg)
    for r, o in enumerate(_ranks(port, leg)):
        np.testing.assert_allclose(o[f"{leg}_loss"], losses, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(o[f"{leg}_params"], views[r], rtol=TOL,
                                   atol=TOL)


def test_moe_onebit_ef_matches_reference(port, data):
    leg = "dp2_ep2_onebit_ef"
    losses, views = _ref_moe(data, leg)
    names = leaf_names(data[0])
    for r, o in enumerate(_ranks(port, leg)):
        np.testing.assert_allclose(o[f"{leg}_loss"], losses,
                                   rtol=ONEBIT_LOSS_TOL,
                                   atol=ONEBIT_LOSS_TOL)
        assert_onebit_held(o[f"{leg}_params"], views[r], names)


@pytest.mark.parametrize("leg,micro", [("dp2_ep2", 1), ("ep2_tp2", 1),
                                       ("pp2_dp2_ep2", 2)])
def test_moe_collectives(port, leg, micro):
    """Two exchanges over ep (dispatch, combine) a layer and microbatch
    each way, one ep gradient sum a step; pp2: a stage's one layer runs
    its microbatches, and the stages shift M + S − 2 = 2 times a step."""
    kinds = list(collectives)
    steps, layers = 3, 2
    per_rank_layers = layers // (2 if leg.startswith("pp") else 1)
    for o in _ranks(port, leg):
        got = dict(zip(kinds, o[f"{leg}_collectives"].tolist()))
        want = steps * per_rank_layers * micro * 2
        assert got["ep_all_to_all_fwd"] == got["ep_all_to_all_bwd"] == want
        assert got["ep_grad_sum"] == steps
        if leg.startswith("pp"):
            assert got["pp_shift_fwd"] == got["pp_shift_bwd"] == steps * 2
            assert got["pp_grad_sum"] == steps


@pytest.mark.parametrize("leg", TRAIN)
def test_moe_params_bit_identical_across_ranks(port, leg):
    outs = _ranks(port, leg)
    for o in outs[1:]:
        np.testing.assert_array_equal(o[f"{leg}_params"],
                                      outs[0][f"{leg}_params"])


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------
def test_moe_refusals():
    from byteps_tpu_torch.models import (MoEGPTConfig,
                                         make_gpt_moe_pp_train_step,
                                         make_gpt_moe_train_step)

    cfg = MoEGPTConfig.tiny()
    with pytest.raises(ValueError, match="mesh has a pp axis — use "
                                         "make_gpt_moe_pp_train_step"):
        make_gpt_moe_train_step(cfg, fake_mesh({"pp": 2, "ep": 2}, 0),
                                device="cpu")
    three = MoEGPTConfig(**{**cfg.__dict__, "n_experts": 3})
    with pytest.raises(ValueError, match="n_experts=3 not divisible by "
                                         "ep=2"):
        make_gpt_moe_train_step(three, fake_mesh({"ep": 2}, 0),
                                device="cpu")
    with pytest.raises(ValueError, match="n_experts=3 not divisible by "
                                         "ep=2"):
        make_gpt_moe_pp_train_step(three, fake_mesh({"pp": 2, "ep": 2}, 0),
                                   device="cpu")
    with pytest.raises(ValueError, match="mesh has no pp axis — use "
                                         "make_gpt_moe_train_step"):
        make_gpt_moe_pp_train_step(cfg, fake_mesh({"ep": 2}, 0),
                                   device="cpu")
    odd = MoEGPTConfig(**{**cfg.__dict__, "n_layers": 3})
    with pytest.raises(ValueError, match="n_layers=3 not divisible by "
                                         "pp=2"):
        make_gpt_moe_pp_train_step(odd, fake_mesh({"pp": 2}, 0),
                                   device="cpu")
