"""Sharded decode: the port's generate over tp and ep, MoE blocks in the
cached step, and LoRA on a tp mesh (the segmented delta's row-parallel
arm), against the reference on the CPU in f32, from the reference's own
weights.

The port's sharded legs run as gloo rank processes
(``tests/helpers/sharded_rank.py``, each group once a test session under
a file lock), the reference's in ``jax.shard_map`` on the conftest's CPU
devices (as ``tests/test_generate.py`` runs its sharded generate):

* MoE generate on one rank (``MoEGPTConfig.tiny()``): greedy tokens equal
  to the reference's ``make_generate_fn`` exactly, the prefill's logits
  within 1e-5 of their largest magnitude.
* ``make_generate_fn(tp_axis=, ep_axis=)`` on tp2 (GPT tiny, dense and
  ``quant_cache``), ep2 and ep2×tp2 (the MoE GPT): every rank's greedy
  tokens equal to the reference's sharded ``make_generate_fn`` exactly,
  and the sharded prefill's logits within 1e-5 of the largest magnitude
  of the reference's (the tp sums add in another order).
* A grafted rank-4 LoRA tree on ``wq``, ``wv``, ``wo`` and ``w2`` (scale
  1.5, ``b`` nonzero) on tp2, the adapters cut by
  ``adapters_from_numpy(mesh=)`` (by ``lora_param_specs``):
  ``gpt_forward``'s logits within 1e-5
  of max of the reference's ``gpt_forward`` in ``shard_map`` (whose
  ``lora_delta(tp_axis)`` sums the row targets' intermediate over tp),
  greedy tokens equal to the reference's sharded generate on the grafted
  tree, and ``adapters_to_numpy(mesh=)`` giving the whole tree back bit
  for bit.
* ``lora_param_specs`` equal to the reference's, every target.
* ``segmented_lora_delta(row_parallel=True, tp_axis=)`` on tp2 (each rank
  its half of ``d_in``): within 1e-5 of max of the reference's
  ``_delta_jnp(row_parallel=True)`` in ``shard_map``, one tp sum issued;
  and its halves on one rank: ``down_torch``'s f32 ``u`` within 1e-5 of
  max of the reference's first dot (each row's ``x @ A[slot]``, as
  ``_delta_jnp`` emits it), and ``up_torch(down_torch(x))`` (which is
  ``delta_torch``) bit-equal, f32 and bf16, to the one-piece plain
  version the port had before the split, kept in the test as a literal
  (the same products, summed in the same order).
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

from byteps_tpu.models import GPTConfig as JConfig  # noqa: E402
from byteps_tpu.models import gpt_param_specs as j_gpt_specs  # noqa: E402
from byteps_tpu.models import moe_gpt_param_specs as j_moe_specs  # noqa: E402,E501
from byteps_tpu.models import generate as jgen  # noqa: E402
from byteps_tpu.models.gpt import gpt_forward as j_forward  # noqa: E402
from byteps_tpu.models.gpt import gpt_init as j_init  # noqa: E402
from byteps_tpu.models.lora import graft_lora as j_graft  # noqa: E402
from byteps_tpu.models.lora import lora_param_specs as j_lora_specs  # noqa: E402,E501
from byteps_tpu.models.moe_gpt import MoEGPTConfig as JMoEConfig  # noqa: E402
from byteps_tpu.models.moe_gpt import moe_gpt_init as j_moe_init  # noqa: E402
from byteps_tpu.ops.segmented_lora import _delta_jnp  # noqa: E402
from byteps_tpu_torch.models import (GPTConfig, MoEGPTConfig,  # noqa: E402
                                     params_from_numpy)
from byteps_tpu_torch.models import generate as tgen  # noqa: E402
from byteps_tpu_torch.models.lora import lora_param_specs  # noqa: E402
from byteps_tpu_torch.ops.segmented_lora import (delta_torch,  # noqa: E402
                                                 down_torch, up_torch)

torch.set_num_threads(1)
LOGIT_TOL = 1e-5                 # of the largest logit magnitude
MAX_NEW = 8
LORA_TARGETS = ("w2", "wo", "wq", "wv")
LORA_RANK, LORA_SCALE = 4, 1.5
SEG = {"R": 3, "S": 2, "d_in": 64, "rb": 8, "d_out": 48, "n_slots": 3}
LEGS = {
    2: [{"name": "tp2", "kind": "generate", "mesh": {"tp": 2},
         "tree": "tiny", "max_new": MAX_NEW},
        {"name": "tp2_quant", "kind": "generate", "mesh": {"tp": 2},
         "tree": "tiny", "max_new": MAX_NEW, "quant": True},
        {"name": "tp2_lora", "kind": "generate", "mesh": {"tp": 2},
         "tree": "tiny", "max_new": MAX_NEW, "lora": True,
         "targets": list(LORA_TARGETS), "rank": LORA_RANK,
         "scale": LORA_SCALE},
        {"name": "ep2", "kind": "generate", "mesh": {"ep": 2},
         "tree": "moe", "moe": True, "max_new": MAX_NEW},
        {"name": "seg_tp2", "kind": "seg_rowpar", "mesh": {"tp": 2}}],
    4: [{"name": "ep2tp2", "kind": "generate", "mesh": {"ep": 2, "tp": 2},
         "tree": "moe", "moe": True, "max_new": MAX_NEW}],
}
# the reference's axes of each generate leg
AXES = {"tp2": ("tp", None), "tp2_quant": ("tp", None),
        "tp2_lora": ("tp", None), "ep2": (None, "ep"),
        "ep2tp2": ("tp", "ep")}


def _prompt(name):
    return np.random.default_rng(len(name)).integers(
        0, 256, (2, 7)).astype(np.int32)


def _adapters():
    """A reference-shaped adapter tree with a nonzero ``b``."""
    rng = np.random.default_rng(5)
    cfg = JConfig.tiny()
    dims = {"wq": (64, 64), "wv": (64, 64), "wo": (64, 64),
            "w2": (cfg.d_ff, 64)}
    return {"blocks": [
        {t: {"a": (rng.standard_normal((dims[t][0], LORA_RANK))
                   / LORA_RANK ** 0.5).astype(np.float32),
             "b": (rng.standard_normal((LORA_RANK, dims[t][1])) * 0.1
                   ).astype(np.float32)} for t in LORA_TARGETS}
        for _ in range(cfg.n_layers)]}


def _seg_inputs():
    rng = np.random.default_rng(9)
    s = SEG
    return {"seg_x": rng.standard_normal((s["R"], s["S"], s["d_in"])
                                         ).astype(np.float32),
            "seg_a": rng.standard_normal((s["n_slots"], s["d_in"], s["rb"])
                                         ).astype(np.float32),
            "seg_b": rng.standard_normal((s["n_slots"], s["rb"],
                                          s["d_out"])).astype(np.float32),
            "seg_slots": np.array([2, 0, 1], np.int32)}


@pytest.fixture(scope="module")
def data():
    trees = {"tiny": j_init(jax.random.PRNGKey(0), JConfig.tiny()),
             "moe": j_moe_init(jax.random.PRNGKey(1), JMoEConfig.tiny())}
    trees = {k: jax.tree.map(np.asarray, t) for k, t in trees.items()}
    arrays = {f"{g['name']}_prompt": _prompt(g["name"])
              for legs in LEGS.values() for g in legs}
    for t, tree in trees.items():
        arrays.update({f"{t}_p{i}": a
                       for i, a in enumerate(tree_leaves(tree))})
    ad = _adapters()
    for i, blk in enumerate(ad["blocks"]):
        for t, ab in blk.items():
            arrays.update({f"lora_{i}_{t}_{k}": v for k, v in ab.items()})
    arrays.update(_seg_inputs())
    return trees, ad, arrays


@pytest.fixture(scope="module")
def port(data, tmp_path_factory):
    return port_groups("torch_generate_parallel", LEGS, data[2],
                       tmp_path_factory, script="sharded_rank.py")


def _leg(name):
    return next(g for legs in LEGS.values() for g in legs
                if g["name"] == name)


def _ranks(port, name):
    n = next(k for k, legs in LEGS.items()
             if any(g["name"] == name for g in legs))
    return port[n]


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _jcfg(leg):
    return JMoEConfig.tiny() if leg.get("moe") else JConfig.tiny()


def _ref_sharded(name, data):
    """The reference's sharded generate tokens and its prefill logits on
    the leg's mesh (``shard_map``, ``check_vma=False``)."""
    trees, ad, arrays = data
    leg = _leg(name)
    jcfg = _jcfg(leg)
    tp, ep = AXES[name]
    params = jax.tree.map(jnp.asarray, trees[leg["tree"]])
    specs = (j_moe_specs(jcfg, ep, tp) if leg.get("moe")
             else j_gpt_specs(jcfg, tp))
    mesh = j_mesh(leg["mesh"])
    prompt = jnp.asarray(arrays[f"{name}_prompt"])
    quant = leg.get("quant", False)
    lora = jax.tree.map(jnp.asarray, ad) if leg.get("lora") else None
    lspecs = (j_lora_specs(jcfg, tp, LORA_RANK, LORA_TARGETS)
              if lora else None)

    def tree(p, a):
        return p if a is None else j_graft(p, a, LORA_SCALE)

    gen = jgen.make_generate_fn(jcfg, MAX_NEW, tp_axis=tp, ep_axis=ep,
                                quant_cache=quant)

    def run(p, a, t):
        p = tree(p, a)
        kv = p["blocks"][0]["wk"].shape[-1] // jcfg.head_dim
        cache = jgen.init_cache(jcfg, t.shape[0], h_loc=kv, quant=quant)
        logits, _ = jgen.gpt_apply_cached(p, t, cache, jcfg, tp, ep)
        fwd = (j_forward(p, t, jcfg, tp_axis=tp) if a is not None
               else logits)
        return gen(p, t, jax.random.PRNGKey(0), 0.0), logits, fwd

    toks, logits, fwd = jax.jit(jax.shard_map(
        run, mesh=mesh, in_specs=(specs, lspecs, P()),
        out_specs=(P(), P(), P()), check_vma=False))(params, lora, prompt)
    return np.asarray(toks), np.asarray(logits), np.asarray(fwd)


# --------------------------------------------------------------------------
# one rank: the MoE cached step
# --------------------------------------------------------------------------
def test_moe_generate_one_rank_matches_reference(data):
    trees, _, _ = data
    jcfg, tcfg = JMoEConfig.tiny(), MoEGPTConfig.tiny()
    tp = params_from_numpy(trees["moe"], tcfg, device="cpu")
    prompt = _prompt("one_rank_moe")
    want = np.asarray(jgen.make_generate_fn(jcfg, MAX_NEW)(
        jax.tree.map(jnp.asarray, trees["moe"]), jnp.asarray(prompt),
        jax.random.PRNGKey(0), 0.0))
    got = tgen.make_generate_fn(tcfg, MAX_NEW, device="cpu")(
        tp, prompt).numpy()
    np.testing.assert_array_equal(got, want)
    jl, _ = jgen.gpt_apply_cached(
        jax.tree.map(jnp.asarray, trees["moe"]), jnp.asarray(prompt),
        jgen.init_cache(jcfg, 2, h_loc=jcfg.kv_heads), jcfg)
    tl, _ = tgen.gpt_apply_cached(
        tp, torch.as_tensor(prompt), tgen.init_cache(tcfg, 2, device="cpu"),
        tcfg)
    _close(tl.numpy(), np.asarray(jl))


# --------------------------------------------------------------------------
# sharded generate
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(AXES))
def test_sharded_generate_matches_reference(port, data, name):
    toks, logits, fwd = _ref_sharded(name, data)
    outs = _ranks(port, name)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o[f"{name}_tokens"], toks,
                                      err_msg=f"rank {r}")
        _close(o[f"{name}_logits"], logits)
    if name == "tp2_lora":
        _, ad, _ = data
        for o in outs:
            _close(o[f"{name}_fwd"], fwd)
            np.testing.assert_array_equal(o[f"{name}_adapters"], np.concatenate(
                [ad["blocks"][i][t][k].ravel()
                 for i in range(len(ad["blocks"])) for t in LORA_TARGETS
                 for k in ("a", "b")]))


def test_lora_param_specs_equal_reference():
    for tp in (None, "tp"):
        want = j_lora_specs(JConfig.tiny(), tp, LORA_RANK,
                            ("wq", "wk", "wv", "wo", "w1", "w2"))
        got = lora_param_specs(GPTConfig.tiny(), tp, LORA_RANK,
                               ("wq", "wk", "wv", "wo", "w1", "w2"))
        assert len(got["blocks"]) == len(want["blocks"])
        for g, w in zip(got["blocks"], want["blocks"]):
            assert sorted(g) == sorted(w)
            for t in g:
                for k in ("a", "b"):
                    assert g[t][k] == tuple(w[t][k]), (tp, t, k)


# --------------------------------------------------------------------------
# the segmented delta's row-parallel arm
# --------------------------------------------------------------------------
def test_row_parallel_delta_matches_reference(port, data):
    _, _, arrays = data
    mesh = j_mesh({"tp": 2})
    want = np.asarray(jax.jit(jax.shard_map(
        lambda x, a, b, s: _delta_jnp(x, a, b, s, tp_axis="tp",
                                      row_parallel=True),
        mesh=mesh, in_specs=(P(None, None, "tp"), P(None, "tp", None), P(),
                             P()),
        out_specs=P(), check_vma=False))(
            *(jnp.asarray(arrays[k]) for k in ("seg_x", "seg_a", "seg_b",
                                                "seg_slots"))))
    for o in port[2]:
        _close(o["seg_tp2_delta"], want)
        assert int(o["seg_tp2_sums"]) == 1


def _one_piece_delta(x, a_slab, b_slab, slots):
    """The port's plain version before its split into halves, verbatim."""
    idx = slots.long()
    a = a_slab[idx].float()                              # (R, d_in, rb)
    b = b_slab[idx].float()                              # (R, rb, d_out)
    u = (x.float()[..., :, None] * a[:, None]).sum(-2)   # (R, S, rb)
    out = u[..., 0:1] * b[:, None, 0]
    for j in range(1, b.shape[1]):
        out = out + u[..., j:j + 1] * b[:, None, j]
    return out.to(x.dtype)


def test_plain_halves_match_reference_and_one_piece_version(data):
    _, _, arrays = data
    x, a, b, s = (torch.from_numpy(arrays[k]) for k in ("seg_x", "seg_a",
                                                        "seg_b",
                                                        "seg_slots"))
    u = down_torch(x, a, s)
    assert u.dtype == torch.float32 and u.shape == (3, 2, SEG["rb"])
    ja = jnp.asarray(arrays["seg_a"])
    want_u = np.concatenate([np.asarray(
        jnp.asarray(arrays["seg_x"][i:i + 1])
        @ jnp.take(ja, int(arrays["seg_slots"][i]), axis=0))
        for i in range(SEG["R"])])
    _close(u.numpy(), want_u)
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        want = _one_piece_delta(xd, a, b, s).float().numpy()
        np.testing.assert_array_equal(
            up_torch(down_torch(xd, a, s), b, s, dt).float().numpy(), want)
        np.testing.assert_array_equal(
            delta_torch(xd, a, b, s).float().numpy(), want)
