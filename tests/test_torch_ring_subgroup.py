"""The ring tier over a mesh subgroup (a dp line of a dp×tp job, the
``slice_`` line of the hierarchical path) against the staged tier and the
reference, on the CPU.

The port runs as gloo rank processes (``tests/helpers/sharded_rank.py``,
each group once a test session under a file lock); the reference on the
conftest's CPU devices.

* ``ring_collect``, ``ring_allgather`` and ``ring_presum`` over each dp
  line of a dp2×tp2 job (lines {0, 2} and {1, 3}) and of a dp3×tp2 job
  (lines {0, 2, 4} and {1, 3, 5}: a chain of three, whose group indices
  are not the global ranks), f32, f16 and int32 rows: each rank's result
  bit-equal to the reference's ring twin over that line's rows on a
  device mesh of the line's size, and (collect, all-gather) to the
  staged bodies (``comm/ici.py``'s ``all_to_all_single`` and
  ``all_gather`` over the same group). Exact: the ring moves bits, and
  presum is the reference's chain of f32 adds in its order.
* ``DistributedOptimizer`` alone over the dp axis of dp2×tp2 (SGD at lr 1
  from zero, three steps of random gradient rows, 1,001 elements chunked
  by 256 partition bytes) with ``BYTEPS_ICI_TIER=ring``: onebit + EF
  (rotate calls over each dp line) and randomk + EF (the presum chain
  over each line), each rank's parameter and EF residual after every
  step bit-equal to the staged tier's; onebit within 1e-6 relative of the
  reference's ``DistributedOptimizer`` with the ring tier over that line's
  two rows (its scales reduce in another order, as
  ``tests/test_torch_multislice.py`` holds them), the EF residual too.
* The hierarchical path (slice_=2, dp=2), onebit + EF and randomk + EF
  over the ``slice_`` line with the ring tier: bit-equal to the staged
  tier; against the reference's ``dcn_axis`` step with the ring tier,
  onebit within 1e-6 relative; randomk, given the reference's own draws
  (``tests/test_torch_multislice.py``'s tables), its EF residual exact
  and its parameter within 1e-6 relative: the reference's ring step
  itself differs from its staged step by one ulp on 28 of the 3,003
  values (measured), where the port's ring step is bit-equal to its
  staged one, which ``tests/test_torch_multislice.py`` holds bit-equal
  to the reference's staged step.
* ``make_gpt_train_step`` on dp2×tp2 with onebit + EF, replicated and
  ZeRO-1 over the dp subgroup, 3 AdamW steps: the ring tier's losses and
  every rank's parameters bit-equal to the staged tier's.
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
from pp_moe_parity import batch, port_groups, tree_leaves  # noqa: E402
from train_parity import ONEBIT_EF  # noqa: E402

import test_torch_multislice as tms  # noqa: E402
from test_torch_ring import _ref  # noqa: E402
from byteps_tpu.common import config as jconfig  # noqa: E402
from byteps_tpu.jax.optimizer import DistributedOptimizer as JDistOpt  # noqa: E402,E501
from byteps_tpu.jax.optimizer import dp_state_specs  # noqa: E402
from byteps_tpu.models import GPTConfig as JConfig  # noqa: E402
from byteps_tpu.models.gpt import gpt_init as j_init  # noqa: E402
from byteps_tpu_torch.parallel.mesh import rank_coords  # noqa: E402
from byteps_tpu_torch.parallel.mesh import MeshAxes as TMeshAxes  # noqa: E402,E501

torch.set_num_threads(1)
RING_DTYPES = {"f32": np.float32, "f16": np.float16, "i32": np.int32}
RING_MESHES = {4: ("dp2tp2", {"dp": 2, "tp": 2}),
               6: ("dp3tp2", {"dp": 3, "tp": 2})}
DP_TP = {"dp": 2, "tp": 2}
STEPS, L, PB = 3, 1001, 256
ONEBIT_RTOL = 1e-6
RANDOMK_EF = {"compressor": "randomk", "k": 0.25, "ef": "vanilla"}
DP_OPT = {"dp_onebit": ONEBIT_EF, "dp_randomk": RANDOMK_EF}
HIER = ("hier_onebit", "hier_randomk")
TRAIN = {"dp2tp2_onebit": {"compression_params": ONEBIT_EF},
         "dp2tp2_zero1_onebit": {"compression_params": ONEBIT_EF,
                                 "zero_1": True}}
TIERS = ("ring", "staged")


def _legs() -> dict:
    legs = {n: [{"name": name, "kind": "ring_ops", "mesh": mesh,
                 "dtypes": sorted(RING_DTYPES)}]
            for n, (name, mesh) in RING_MESHES.items()}
    # the hierarchical randomk legs hand each rank the reference's draws
    # for good (multislice_rank._hier_opt), so they run after the port's
    # own randomk draws
    legs[4] += [{"name": f"{nm}_{tier}", "kind": "dp_opt", "mesh": DP_TP,
                 "comp": c, "steps": STEPS, "L": L, "pb": PB, "tier": tier}
                for tier in TIERS for nm, c in DP_OPT.items()]
    legs[4] += [{"name": f"{nm}_{tier}", "kind": "train", "mesh": DP_TP,
                 "tree": "tiny", "kw": kw, "tier": tier}
                for tier in TIERS for nm, kw in TRAIN.items()]
    legs[4] += [{**tms._leg(nm), "name": f"{nm}_{tier}", "tier": tier}
                for tier in TIERS for nm in HIER]
    return legs


LEGS = _legs()


def _ring_rows(name, n, dt) -> np.ndarray:
    """Every rank's (n_dp, 3, 5) rows of leg ``name``."""
    n_dp = RING_MESHES[n][1]["dp"]
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, n_dp, 3, 5)) * 100
    return x.astype(RING_DTYPES[dt])


def _dp_rows() -> np.ndarray:
    return np.random.default_rng(7).standard_normal(
        (STEPS, 4, L)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    tree = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0),
                                           JConfig.tiny()))
    tok, tgt = batch()
    arrays = {"tok": tok, "tgt": tgt, "dp_rows": _dp_rows()}
    arrays.update({f"tiny_p{i}": a for i, a in enumerate(tree_leaves(tree))})
    for n, (name, _) in RING_MESHES.items():
        arrays.update({f"{name}_{dt}_rows": _ring_rows(name, n, dt)
                       for dt in RING_DTYPES})
    arrays[f"hier_rows_{tms.HIER_L}"] = tms._hier_rows(tms.HIER_L)
    keys, idx = tms._hier_draws()
    arrays["draw_keys"] = np.array(keys, np.uint64)
    arrays.update({f"draw_{i}": a for i, a in enumerate(idx)})
    return arrays


@pytest.fixture(scope="module")
def port(data, tmp_path_factory):
    return port_groups("torch_ring_subgroup", LEGS, data, tmp_path_factory,
                       script="sharded_rank.py")


def _lines(n):
    """The dp lines of RING_MESHES[n]: global ranks in index order."""
    _, mesh = RING_MESHES[n]
    axes = TMeshAxes(**mesh)
    lines = {}
    for r in range(n):
        c = rank_coords(axes, r)
        lines.setdefault(c["tp"], []).append(r)
    return list(lines.values())


@pytest.fixture
def ring_tier(monkeypatch):
    """The reference's config with ``BYTEPS_ICI_TIER=ring``."""
    monkeypatch.setenv("BYTEPS_ICI_TIER", "ring")
    jconfig.reset_config()
    yield
    monkeypatch.delenv("BYTEPS_ICI_TIER")
    jconfig.reset_config()


# --------------------------------------------------------------------------
# the transport over each dp line
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n", sorted(RING_MESHES))
@pytest.mark.parametrize("dt", sorted(RING_DTYPES))
def test_ring_ops_over_each_dp_line_equal_the_reference_and_staged(
        port, data, n, dt):
    name, _ = RING_MESHES[n]
    key = f"{name}_{dt}"
    rows = data[f"{key}_rows"]
    outs = port[n]
    for line in _lines(n):
        k = len(line)
        x = rows[line]                                  # (k, k, 3, 5)
        want = {"collect": _ref("collect", x, k),
                "gather": _ref("gather", np.ascontiguousarray(x[:, 0]), k)}
        if dt == "f32":
            want["presum"] = _ref("presum", x, k)
        for i, r in enumerate(line):
            o = outs[r]
            for op, w in want.items():
                np.testing.assert_array_equal(o[f"{key}_{op}"], w[i],
                                              err_msg=f"{op} rank {r}")
            for op in ("collect", "gather"):
                np.testing.assert_array_equal(o[f"{key}_{op}"],
                                              o[f"{key}_staged_{op}"])


# --------------------------------------------------------------------------
# the optimizer's aggregation over a dp line, and over slice_
# --------------------------------------------------------------------------
def _ref_dp(comp, rows2):
    """The reference's ``DistributedOptimizer`` over a dp=2 mesh (the
    tier from its config), sgd(1.0) from zero, on one line's (STEPS, 2,
    L) rows: (the parameter after each step, each device's EF block
    after each step)."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    tx = JDistOpt(optax.sgd(1.0), compression_params=dict(comp), axis="dp",
                  num_devices=2, partition_bytes=PB)
    params = {"w": jnp.zeros((L,))}
    state = tx.init(params)
    sspec = dp_state_specs("dp")

    def step(params, state, g):
        upd, state = tx.update({"w": g.reshape(L)}, state, params)
        return jax.tree.map(lambda p, u: p + u, params, upd), state

    sm = jax.jit(jax.shard_map(step, mesh=mesh,
                               in_specs=(P(), sspec, P("dp")),
                               out_specs=(P(), sspec), check_vma=False))
    ws, efs = [], []
    for s in range(STEPS):
        params, state = sm(params, state, jnp.asarray(rows2[s]))
        ws.append(np.asarray(params["w"]))
        efs.append(np.asarray(state.ef).reshape(2, -1))
    return np.stack(ws), np.stack(efs, 1)


@pytest.mark.parametrize("name", sorted(DP_OPT) + list(HIER))
def test_optimizer_ring_over_a_subgroup_is_bit_equal_to_staged(port, name):
    for r, o in enumerate(port[4]):
        for what in ("w", "ef"):
            np.testing.assert_array_equal(
                o[f"{name}_ring_{what}"], o[f"{name}_staged_{what}"],
                err_msg=f"{name} {what} rank {r}")


def test_dp_onebit_ring_matches_reference_ring_tier(port, data, ring_tier):
    rows = data["dp_rows"]
    for line in _lines(4):
        w, ef = _ref_dp(ONEBIT_EF, rows[:, line])
        for i, r in enumerate(line):
            o = port[4][r]
            np.testing.assert_allclose(o["dp_onebit_ring_w"], w,
                                       rtol=ONEBIT_RTOL, atol=ONEBIT_RTOL
                                       * np.abs(w).max())
            np.testing.assert_allclose(o["dp_onebit_ring_ef"], ef[i],
                                       rtol=ONEBIT_RTOL, atol=ONEBIT_RTOL
                                       * np.abs(ef).max())


@pytest.mark.parametrize("name", HIER)
def test_hierarchical_ring_matches_reference_ring_tier(port, name,
                                                       ring_tier):
    w, ef = tms._ref_hier(name)
    for r, o in enumerate(port[4]):
        got_w, got_ef = o[f"{name}_ring_w"], o[f"{name}_ring_ef"]
        if name == "hier_randomk":
            np.testing.assert_array_equal(got_ef, ef[r])
            np.testing.assert_allclose(got_w, w, rtol=ONEBIT_RTOL, atol=0)
        else:
            np.testing.assert_allclose(got_w, w, rtol=ONEBIT_RTOL,
                                       atol=ONEBIT_RTOL * np.abs(w).max())
            np.testing.assert_allclose(got_ef, ef[r], rtol=ONEBIT_RTOL,
                                       atol=ONEBIT_RTOL * np.abs(ef).max())


# --------------------------------------------------------------------------
# the train step over a dp×tp mesh
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(TRAIN))
def test_train_ring_over_dp_lines_is_bit_equal_to_staged(port, name):
    for r, o in enumerate(port[4]):
        for what in ("loss", "local", "params"):
            np.testing.assert_array_equal(
                o[f"{name}_ring_{what}"], o[f"{name}_staged_{what}"],
                err_msg=f"{name} {what} rank {r}")
        assert np.isfinite(o[f"{name}_ring_loss"]).all()
